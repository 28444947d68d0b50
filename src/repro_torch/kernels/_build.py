"""Build, load and launch the port's CUDA kernels.

The sources under ``repro_torch/csrc`` have a plain C interface. At
first use ``library()`` compiles each ``.cu`` file with nvcc for
``sm_90a`` (all compiles started together), links the objects into one
shared library under ``build/repro_torch/`` at the repository root and
loads it with ``ctypes``. Nothing is built when a module is imported,
and the library name carries a hash of the sources and flags, so an
edited source is rebuilt.

Every wrapper checks its operands with ``check_cuda``, allocates its
outputs and scratch with ``torch.empty``, launches on PyTorch's current
stream through ``call`` (which raises on a non-zero CUDA error code)
and records the launch (``count_launch``: one more in
``LAUNCHES``, the largest input shape in ``MAX_SHAPES``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("compact.cu", "hash_rows.cu", "group_build.cu", "expand.cu",
           "segment_reduce.cu", "radix_rank.cu", "flash_attention.cu",
           "decode_attention.cu", "ssd.cu", "shard_rank.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# C entry point -> argument types (pointers and the stream are c_void_p)
SIGNATURES = {
    "repro_prefix_count": (_P, _P, _P, _I, _P),
    "repro_running_segment_ids": (_P, _P, _P, _I, _P),
    "repro_group_boundaries": (_P, _P, _P, _P, _I, _P),
    "repro_hash_rows": (_P, _P, _LL, _I, _P),
    "repro_lookback_tile": (),
    "repro_lookback_tiles": (_I,),
    "repro_segment_reduce": (_P, _P, _P, _I, _I, _I, _I, _P),
    "repro_segment_reduce_batch": (),
    "repro_segment_reduce_shared_max": (),
    "repro_radix_rank": (_P, _P, _P, _P, _I, _I, _P),
    "repro_radix_rank_tiles": (_I,),
    # q, k, v, o, B, H, K, Sq, Sk, d, the (b, h, s) strides of q, k, v
    # and o, scale, causal, window, stream
    "repro_flash_attention": (_P,) * 4 + (_I,) * 6 + (_LL,) * 12
    + (_F, _I, _I, _P),
    # q, k, v, lengths, slot_pos, pos, window, o, lse, B, H, K, T, d, q
    # (b, h), k and v (b, kv, t), o (b, h) strides, scale, scratch, stream
    "repro_decode_attention": (_P,) * 6 + (_I, _P, _P) + (_I,) * 5
    + (_LL,) * 10 + (_F, _P, _P),
    "repro_decode_chunk": (),
    # B, H, K, T, d -> scratch bytes
    "repro_decode_scratch_bytes": (_I,) * 5,
    # x, dt, A, B, C, y, states, decay, cum, b, s, h, p, n, chunk, head
    # groups, x (b, s, h), B (b, s) and C (b, s) strides, stream
    "repro_ssd_chunk": (_P,) * 9 + (_I,) * 7 + (_LL,) * 7 + (_P,),
    # b, chunks, h, chunk, p, n -> head groups
    "repro_ssd_groups": (_I,) * 6,
    # dest, base, out, scratch (1 + tiles * P int64 words), n, P, stream
    "repro_shard_rank": (_P, _P, _P, _P, _I, _I, _P),
    "repro_shard_rank_tiles": (_I,),
}

# C entry points that return other than a C int
RESTYPES = {"repro_decode_scratch_bytes": _LL}

# kernel name -> launches since the last reset_launches(), and the
# largest input shape launched in that time
LAUNCHES = {"prefix_count": 0, "hash_rows": 0, "group_boundaries": 0,
            "running_segment_ids": 0, "segment_reduce": 0, "radix_rank": 0,
            "flash_attention": 0, "decode_attention": 0, "ssd_chunk": 0,
            "shard_rank": 0}
MAX_SHAPES: dict[str, tuple] = {}
# (kernel name, variant, input shape) -> launches since the last
# reset_launches(): K7's variant is its mask ("causal", "bidir", with
# "+window"), K8's ("lengths", "slot_mask", "lengths_lse" and
# "slot_mask_lse" for the log-sum-exp route), others' None
SHAPE_LAUNCHES: dict[tuple, int] = {}

_LIB: ctypes.CDLL | None = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    """Zero every launch counter and forget the shapes."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    MAX_SHAPES.clear()
    SHAPE_LAUNCHES.clear()


def count_launch(name: str, shape, variant: str | None = None) -> None:
    """Record one launch of kernel ``name`` on an input of ``shape``
    (its leading entry is the row count the largest shape is kept by),
    and under (name, ``variant``, shape) in ``SHAPE_LAUNCHES``."""
    LAUNCHES[name] += 1
    shape = tuple(shape)
    key = (name, variant, shape)
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    old = MAX_SHAPES.get(name)
    if old is None or shape[0] > old[0]:
        MAX_SHAPES[name] = shape


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")
    return found


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:12]


def build() -> Path:
    """Compile and link the kernels if this source hash has no library
    yet; return the library's path. Fills ``BUILD_INFO`` with the build
    time and nvcc's resource report (``-Xptxas -v``)."""
    lib = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, cached=True, log="")
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    t0 = time.perf_counter()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, objs = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        objs.append(str(obj))
    tmp = BUILD_DIR / f"{lib.name}.{tag}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", *objs,
                           "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    for o in objs:
        os.remove(o)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False,
                      log="\n".join(logs))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
               ndim: int, contiguous: bool = True) -> None:
    """Raise unless ``t`` is a CUDA tensor of ``dtype`` with ``ndim``
    dimensions and fewer than 2^31 elements, contiguous (or, with
    ``contiguous=False``, of unit stride on its last axis: a kernel that
    takes the other strides as arguments)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if not contiguous and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: expected unit stride on the last axis, "
                         f"got strides {t.stride()}")
    if t.numel() >= 2**31:
        raise ValueError(f"{name}: {t.numel()} elements exceed int32")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def opt_ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """``ptr(t)``, or a null pointer for an operand left out."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def lookback_scratch(n: int, like: torch.Tensor) -> torch.Tensor:
    """Scratch of the one-pass look-back scan over ``n`` elements: the
    tile counter and one status word per tile, (tiles + 1) int64. The
    launch zeroes it on its stream; each call owns its own."""
    tiles = library().repro_lookback_tiles(n)
    return torch.empty(tiles + 1, dtype=torch.int64, device=like.device)


def call(fn_name: str, device: torch.device, *args) -> None:
    """Launch C entry point ``fn_name`` on ``device``; raise on a
    non-zero CUDA error code."""
    lib = library()
    with torch.cuda.device(device):
        rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {rc} ({msg})")
