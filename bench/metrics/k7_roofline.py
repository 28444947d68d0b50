"""Kernels: K7 (``csrc/flash_attention.cu``) as a share of its
roofline: the least time its launches of the window could take,
max(bytes / HBM rate, operations / dense peak) at each launch's shape,
over the device time the profiler gave its kernel, in %."""
import re

from bench import flops, peaks

KERNEL = re.compile(r"(^|[\s:])flash_fwd_kernel\b")


def read(run):
    tr = run["trace"]
    if not tr or not tr["k7"]:
        return None
    bound = sum(n * flops.bound_s(*flops.k7_work(shape, variant),
                                  peaks.DENSE_TENSOR_FLOPS,
                                  peaks.HBM_BYTES_PER_S)
                for (shape, variant), n in tr["k7"].items())
    took = sum(s for name, s in tr["by_name"].items() if KERNEL.search(name))
    return 100 * bound / took if took else None
