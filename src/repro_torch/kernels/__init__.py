"""Device kernels of the port: CUDA sources under ``repro_torch/csrc``,
built with nvcc at first use (``_build.py``), each beside its plain
PyTorch version and its numpy oracle."""
