"""Kernels: K8 (``csrc/decode_attention.cu``) as a share of its
roofline: per round, each layer's launch over the live cache lengths of
its rows, max(bytes / HBM rate, operations / dense peak), over the
device time the profiler gave its kernel, in %."""
import re

from bench import flops, peaks

KERNEL = re.compile(r"(^|[\s:])decode_kernel\b")


def read(run):
    tr = run["trace"]
    if not tr or not tr["k8"] or not tr["k8_lengths"]:
        return None
    ((shape, _), _), = tr["k8"].items()
    layers = run["config"]["num_hidden_layers"]
    if sum(tr["k8"].values()) != layers * len(tr["k8_lengths"]):
        raise ValueError(f"K8 launched {sum(tr['k8'].values())} times in "
                         f"{len(tr['k8_lengths'])} rounds of {layers} "
                         f"layers")
    bound = layers * sum(flops.bound_s(*flops.k8_work(shape, lengths),
                                       peaks.DENSE_TENSOR_FLOPS,
                                       peaks.HBM_BYTES_PER_S)
                         for lengths in tr["k8_lengths"])
    took = sum(s for name, s in tr["by_name"].items() if KERNEL.search(name))
    return 100 * bound / took if took else None
