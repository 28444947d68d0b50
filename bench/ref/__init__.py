"""Plain references the benchmark holds the program to.

Plain PyTorch and Python, float32 with TF32 off unless a caller asks
for the control's lower precision. Nothing here imports the program
(``repro_torch``) or JAX: the references work out again, from the
benchmark's own tables, weights and prompts, what the program derived.
A model family's forward pass is ``ref/<family>.py``."""
