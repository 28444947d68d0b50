"""The dry run: trace one (arch x shape) cell's step over the production
mesh without a device, and read its FLOPs, memory and collective bytes
(the reference's ``src/repro/launch/dryrun.py``, which lowers and
compiles the cell on 256 or 512 forced host devices).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch stablelm-3b --shape train_4k --out artifacts/dryrun

The port's own step functions (``build_train_step``, ``prefill``,
``decode_step``) run on ``device="meta"`` tensors (shapes and dtypes,
no memory, no kernel) over ``make_production_mesh(devices=["meta"] *
256)`` (or 512 with ``--mesh multi``), every position on ``meta``, at
the reference's cell set-up: heads padded (``pad_heads_for_tp(tp)
.pad_vocab(16 * tp)``), KV heads sharded when tp divides them, the
policy's knobs, and a batch that does not divide the data axes
replicated over them (``dp_axes`` empty, the parameters still FSDP over
them: ``sharding.model.MeshGrid.replicas``). Attention and the SSD run
their plain paths ("ref"); ``--chunk-attn`` sets ``models.layers
.Q_CHUNK`` / ``Q_CHUNK_MODE``.

What it measures, into the JSON (the reference's keys where the port
has a counterpart):

* ``corrected.flops_global``: ``torch.utils.flop_counter
  .FlopCounterMode``'s total over the traced step, which
  ``analysis/roofline.analyze`` reads unchanged. Every layer is traced
  (the reference's scans are a Python loop here), so there is no scan
  undercount to correct. It counts matrix-product-like ops only
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions, attention
  products), not norms, softmax, elementwise or the optimizer's
  arithmetic. Work that positions sharing a device share runs once
  (``sharding.model.gmap``), so replicated work counts once, as the
  reference's global HLO counts it. The MoE's capacity is computed per
  data-rank chunk of tokens, as in the reference's ``shard_map``.
* ``memory.argument_bytes``: the resident bytes of the largest
  position, from its parts' shapes: the parameters, the optimizer state
  for train, the cache for decode.
* ``memory.temp_bytes``: a position's peak live bytes of the storages
  the traced ops make (not the arguments'), tracked on the meta tensors
  by a ``TorchDispatchMode`` with a finalizer per tensor (``LiveBytes``),
  less the outputs' bytes still live at the end (a prefill's new
  cache) over the positions. Every position lies on ``meta`` and the
  trace runs the positions one after another inside each layer, so
  the live set holds every position's activations at once: a
  position's peak is taken at each outermost ``gmap`` call as the live
  bytes at its start over the positions plus the call's own rise (its
  scores, its copies), the largest of these (or the whole peak over
  the positions, if larger). Work that positions sharing a device run
  once (the FSDP gather of a tensor rank's weights, replicated
  results) is counted once and divided with the rest, so it is
  undercounted. ``memory.output_bytes`` is those outputs' bytes per
  position.
* ``collectives``: the bytes each kind moves per device: the tally of
  ``sharding.model.tally_collectives`` at the port's exchange points
  (the all-reduces and all-gathers of ``_collect``, the FSDP gather at
  use and its backward's reduce-scatter, ``sum_replicas``,
  ``combine_partials``, the MoE's token and row exchanges), summed over
  the receiving positions and divided by the positions, all-reduce
  counted twice, as the reference counts it. Every layer is traced, so
  no trip-count scaling is needed; ``collectives_raw`` is the same.
* ``trace_s``: the trace's wall time, in place of ``lower_s`` and
  ``compile_s``.

Reference keys with no counterpart here: ``flops_raw``,
``bytes_accessed_raw`` and ``cost_analysis`` (XLA's cost analysis of
the compiled program: there is no compiler), ``corrected.bytes_global``
(its unoptimized byte count), ``memory.repr`` and ``alias_bytes`` (XLA's
memory analysis), the HLO text and ``trip_chain`` (no while loops).
``probe`` has no second pass to make (there is no scan undercount): the
flag stays for the CLI's sake and is recorded.
"""
from __future__ import annotations

import argparse
import json
import time
import weakref
from pathlib import Path
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import FlopCounterMode

from ..configs import get_config
from ..models import abstract_params, decode_step, init_cache, prefill
from ..models.params import count_params, shard_params
from ..sharding import model as sm
from ..sharding.policy import ShardingPolicy
from ..training.optimizer import AdamWConfig, init_state
from ..training.train_step import build_train_step
from .mesh import make_production_mesh
from .specs import PROFILES, SHAPES, _batch_specs, shape_applicable

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class LiveBytes(TorchDispatchMode):
    """The live bytes of the storages made by the ops run under it
    (storages whose keys are in ``exclude``, the arguments', left out):
    their peak, and a position's peak over ``n`` positions that run one
    after another (``around``: at each outermost ``gmap`` call, the live
    bytes at its start over ``n`` plus the call's own rise)."""

    def __init__(self, exclude: set, n: int = 1):
        super().__init__()
        self.exclude = exclude
        self.n = n
        self.live: dict = {}  # storage key -> [bytes, live tensors]
        self.now = 0
        self.peak = 0
        self.position_peak = 0.0
        self.call_peak = 0
        self.depth = 0

    def around(self, fn, args):
        """``fn(*args)``, one position's call (``sharding.model.gmap``)."""
        if self.depth:
            return fn(*args)
        self.depth += 1
        start = self.call_peak = self.now
        try:
            return fn(*args)
        finally:
            self.depth -= 1
            self.position_peak = max(self.position_peak, start / self.n
                                     + self.call_peak - start)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.exclude:
            return
        ent = self.live.get(key)
        if ent is None:
            ent = self.live[key] = [st.nbytes(), 0]
            self.now += ent[0]
            self.peak = max(self.peak, self.now)
            self.call_peak = max(self.call_peak, self.now)
        ent[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        ent = self.live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            del self.live[key]
            self.now -= ent[0]


def _functional(func) -> bool:
    """An op whose outputs alias none of its inputs and that writes none
    of them (no view, no in-place or out= variant)."""
    schema = func._schema
    return not schema.is_mutable and not any(
        r.alias_info is not None for r in schema.returns)


def _meta_key(x):
    """A hashable key of an op argument: a tensor's shape, strides and
    dtype, other values themselves."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _meta_key(v)) for k, v in x.items()))
    hash(x)
    return x


class ShapeCache(TorchDispatchMode):
    """The outputs of a functional op on meta tensors from a cache keyed
    by its arguments' shapes, strides, dtypes and values: the first call
    runs the op's meta kernel (Python for elementwise ops, ~0.25 ms),
    later calls make empty tensors of the recorded shapes, strides and
    dtypes (tens of µs). The ops, their shapes and so what the trace
    counts are unchanged; views, in-place ops and ops whose output
    shares an input's storage undeclared (``_unsafe_view``) always
    run."""

    def __init__(self):
        super().__init__()
        self.cache: dict = {}
        self.ok: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ok = self.ok.get(func)
        if ok is None:
            ok = self.ok[func] = _functional(func)
        if not ok:
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
        except TypeError:
            return func(*args, **kwargs)
        spec = self.cache.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            ins = {t.untyped_storage()._cdata for t in tree_leaves(
                (args, kwargs)) if isinstance(t, torch.Tensor)}
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            if any(t.untyped_storage()._cdata in ins for t in outs):
                # aliases an input without saying so (``_unsafe_view``)
                self.ok[func] = False
            elif all(t.device.type == "meta" for t in outs):
                self.cache[key] = tree_map(lambda t: _Made(t) if isinstance(
                    t, torch.Tensor) else t, out)
            return out
        return tree_map(lambda m: m.make() if isinstance(m, _Made) else m,
                        spec)


class _Made:
    """A recorded output's shape, strides and dtype (a pytree leaf)."""

    __slots__ = ("shape", "stride", "dtype")

    def __init__(self, t: torch.Tensor):
        self.shape, self.stride, self.dtype = (tuple(t.shape), t.stride(),
                                               t.dtype)

    def make(self) -> torch.Tensor:
        return torch.empty_strided(self.shape, self.stride, dtype=self.dtype,
                                   device="meta")


def _tensors(tree) -> list:
    """Every tensor of a tree of dicts, lists and tuples, ``Sharded``
    leaves' distinct parts included."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, sm.Sharded):
        return [p for _, p in tree.distinct()]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def resident_bytes(trees, g: Optional["sm.MeshGrid"]) -> int:
    """The bytes the largest position holds of ``trees`` (its parts of
    every ``Sharded`` leaf; off a mesh every tensor)."""
    leaves = []
    for tree in trees:
        stack = [tree]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            elif isinstance(node, (sm.Sharded, torch.Tensor)):
                leaves.append(node)
    if g is None:
        return sum(_nbytes(t) for t in leaves)
    return max(sum(_nbytes(x.parts[i, t]) if isinstance(x, sm.Sharded)
                   else _nbytes(x) for x in leaves) for i, t in g.coords())


def _trace_cell(cfg, shape, prof, mesh, policy: ShardingPolicy, *,
                microbatches: Optional[int] = None,
                dtype=torch.bfloat16) -> dict:
    """Trace the cell's step on meta tensors over ``mesh`` (every
    position ``meta``; a (1, 1) mesh is one device) under ``policy``:
    {"flops_global", "memory", "collectives", "trace_s"} (module doc)."""
    on = sm.on_mesh(policy)
    g = sm.mesh_grid(policy) if on else None
    n = g.dp * g.tp if on else 1
    params = abstract_params(cfg, dtype)
    if on:
        params = shard_params(cfg, params, policy, consume=True)
    B, S = shape.global_batch, shape.seq
    pol = policy if on else None
    args: list = [params]
    if shape.kind == "train":
        mb = microbatches if microbatches is not None else prof.microbatches
        opt = AdamWConfig(moment_dtype=prof.moment_dtype)
        state = init_state(params, opt)
        args.append(state)
        batch = _batch_specs(cfg, B, S, dtype)
        step = build_train_step(cfg, opt, num_microbatches=mb,
                                remat=prof.remat,
                                accum_dtype=DTYPES[prof.accum_dtype],
                                policy=pol)

        def run():
            return step(params, state, batch)
    elif shape.kind == "prefill":
        batch = _batch_specs(cfg, B, S, dtype)

        def run():
            return prefill(cfg, params, batch, max_seq=S, attn_impl="ref",
                           ssd_impl="ref", policy=pol)
    else:
        cache = init_cache(cfg, B, S, dtype=dtype, device="meta",
                           policy=pol)
        args.append(cache)
        tokens, pos = (torch.empty((B,), dtype=torch.int32, device="meta")
                       for _ in range(2))

        def run():
            return decode_step(cfg, params, cache, tokens, pos,
                               attn_impl="ref", policy=pol)

    argument_bytes = resident_bytes(args, g)
    exclude = {t.untyped_storage()._cdata for t in _tensors(args)}
    t0 = time.perf_counter()
    live = LiveBytes(exclude, n)
    # the cache innermost: the counters above it see every op
    with sm.tally_collectives() as tally, sm.around_calls(live.around), \
            ShapeCache(), FlopCounterMode(display=False) as flops, live:
        out = run()
    trace_s = time.perf_counter() - t0
    out_keys = set()
    out_bytes = 0
    for t in _tensors(_out_tree(out)):
        key = t.untyped_storage()._cdata
        if key in live.live and key not in out_keys:
            out_keys.add(key)
            out_bytes += live.live[key][0]
    del out
    counts = tally.pop("_counts", {})
    coll = {k: v / n for k, v in tally.items()}
    coll["_counts"] = counts
    return {
        "flops_global": float(flops.get_total_flops()),
        "memory": {"argument_bytes": argument_bytes,
                   "temp_bytes": max(live.position_peak, live.peak / n)
                   - out_bytes / n,
                   "output_bytes": out_bytes / n,
                   "peak_live_bytes_all_positions": live.peak},
        "collectives": coll,
        "trace_s": trace_s,
    }


def _out_tree(out) -> dict:
    """A step's outputs as a tree ``_tensors`` reads."""
    if isinstance(out, (tuple, list)):
        return {str(i): _out_tree(o) for i, o in enumerate(out)}
    return out if isinstance(out, (dict, sm.Sharded, torch.Tensor)) else {}


def cell_policy(cfg0, mesh, multi_pod: bool, B: int, *,
                fsdp_params: bool = True, ep_over_dp: bool = False,
                shard_cache_seq: bool = False, dp_over_tp: bool = False):
    """(cfg, policy, shard_kv): the reference's cell set-up over
    ``mesh`` (module doc)."""
    tp = mesh.shape["model"]
    cfg = cfg0.pad_heads_for_tp(tp).pad_vocab(16 * tp)
    shard_kv = cfg.num_kv_heads > 0 and cfg.num_kv_heads % tp == 0
    policy = ShardingPolicy.for_mesh(mesh, shard_kv_heads=shard_kv)
    policy = policy.replace(fsdp_params=fsdp_params, ep_over_dp=ep_over_dp,
                            shard_cache_seq=shard_cache_seq,
                            dp_over_tp=dp_over_tp)
    if B % policy.dp_size() != 0:
        policy = policy.replace(dp_axes=())  # replicate tiny batches
        policy = policy.replace(fsdp_axes=("pod", "data") if multi_pod
                                else ("data",))
    return cfg, policy, shard_kv


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, verbose: bool = True,
             probe: bool = True, *, chunk_attn: int = 0,
             chunk_mode: str = "triangle",
             fsdp_params: bool = True, ep_over_dp: bool = False,
             shard_cache_seq: bool = False, dp_over_tp: bool = False,
             tag: str = "") -> dict:
    """Trace one cell over the production mesh and write its JSON to
    ``out_dir`` (``<arch>__<shape>__<single|multi>[__tag].json``)."""
    from ..models import layers as layers_mod

    cfg0 = get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg0, shape):
        raise SystemExit(f"{arch} x {shape_name}: skipped (only the "
                         f"sub-quadratic architectures run long_500k)")
    n_dev = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * n_dev)
    B, S = shape.global_batch, shape.seq
    cfg, policy, shard_kv = cell_policy(
        cfg0, mesh, multi_pod, B, fsdp_params=fsdp_params,
        ep_over_dp=ep_over_dp, shard_cache_seq=shard_cache_seq,
        dp_over_tp=dp_over_tp)
    prof = PROFILES[arch]
    saved = layers_mod.Q_CHUNK, layers_mod.Q_CHUNK_MODE
    if chunk_attn:
        layers_mod.Q_CHUNK = chunk_attn
        layers_mod.Q_CHUNK_MODE = chunk_mode
    try:
        got = _trace_cell(cfg, shape, prof, mesh, policy,
                          dtype=DTYPES[prof.param_dtype])
    finally:
        layers_mod.Q_CHUNK, layers_mod.Q_CHUNK_MODE = saved
    result = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "multi" if multi_pod else "single",
        "n_devices": mesh.size,
        "seq": S,
        "global_batch": B,
        "padded_heads": cfg.num_heads,
        "padded_kv_heads": cfg.num_kv_heads,
        "orig_heads": cfg0.num_heads,
        "orig_kv_heads": cfg0.num_kv_heads,
        "shard_kv": shard_kv,
        "params": count_params(cfg),
        "params_active": cfg.active_param_count(),
        "params_orig": count_params(cfg0),
        "microbatches": prof.microbatches if shape.kind == "train" else None,
        "corrected": {"flops_global": got["flops_global"]},
        "memory": got["memory"],
        "collectives_raw": got["collectives"],
        "collectives": got["collectives"],
        "trace_s": got["trace_s"],
        "probe": probe,
        "opt": {"chunk_attn": chunk_attn, "chunk_mode": chunk_mode,
                "fsdp_params": fsdp_params, "ep_over_dp": ep_over_dp,
                "shard_cache_seq": shard_cache_seq,
                "dp_over_tp": dp_over_tp, "tag": tag},
    }
    if verbose:
        print(json.dumps(result, indent=2, default=str))
    if out_dir:
        p = Path(out_dir)
        p.mkdir(parents=True, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fname = (f"{arch}__{shape_name}__"
                 f"{'multi' if multi_pod else 'single'}{suffix}.json")
        (p / fname).write_text(json.dumps(result, indent=2, default=str))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Trace one (arch x shape) cell over the production "
                    "mesh on meta tensors")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--no-probe", action="store_true",
                    help="kept for the reference's CLI: the trace has no "
                         "probe pass to skip")
    ap.add_argument("--chunk-attn", type=int, default=0)
    ap.add_argument("--chunk-mode", default="triangle",
                    choices=["triangle", "scan"])
    ap.add_argument("--no-fsdp-params", action="store_true")
    ap.add_argument("--ep-over-dp", action="store_true")
    ap.add_argument("--shard-cache-seq", action="store_true")
    ap.add_argument("--dp-over-tp", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    run_cell(args.arch, args.shape, args.mesh == "multi", args.out,
             probe=not args.no_probe, chunk_attn=args.chunk_attn,
             chunk_mode=args.chunk_mode,
             fsdp_params=not args.no_fsdp_params,
             ep_over_dp=args.ep_over_dp,
             shard_cache_seq=args.shard_cache_seq,
             dp_over_tp=args.dp_over_tp, tag=args.tag)


if __name__ == "__main__":
    main()
