"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one
NVIDIA H100: ``python3 bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout, with the
cells, metrics and bounds in ``BENCHMARK.json``. It imports neither
JAX nor the JAX package (``repro``)."""
