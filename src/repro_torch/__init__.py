"""PLOP on PyTorch: the hybrid query engine of ``repro`` ported to
PyTorch, with its device kernels written by hand in CUDA for Hopper.

The package mirrors ``repro``'s layout module for module and imports
nothing of it; ``trace.py``, its span recorder, is its own. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
