"""The dry-run tier of the port (``launch/specs.py``, ``launch/dryrun.py``,
``launch/sweep.py``, ``analysis/roofline.py``, the ``Q_CHUNK`` knob of
``models/layers.py``, the collective tally of ``sharding/model.py``):
the roofline algebra on the H100's published peaks, the cells and
abstract inputs against the reference's, tiny configurations traced on
meta tensors over (1, 1), (1, 2) and (2, 2) meshes of ``meta``
positions (FLOPs against an analytic count, the tally against a count
by hand, the argument bytes against the parts' bytes), ``Q_CHUNK`` in
both modes against the reference's attention with its knob set, the
sweep's resume and failure paths, and the bfloat16 SSD the traces run
(the reference promotes its mixed einsums; the port raised). Tests that
need no reference import no jax."""
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.models as pm  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    analyze,
    load_all,
    table,
)
from repro_torch.configs import get_tiny  # noqa: E402
from repro_torch.launch import dryrun, specs, sweep  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.sharding import model as sm  # noqa: E402
from repro_torch.sharding.policy import ShardingPolicy  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWConfig,
    abstract_state,
)

ROOT = Path(__file__).resolve().parent.parent


def _cell(**kw):
    base = {
        "arch": "x", "shape": "train_4k", "kind": "train", "mesh": "single",
        "n_devices": 256, "params_orig": 1e9, "params_active": 1e9,
        "corrected": {"flops_global": 6e9 * 4096 * 256},
        "memory": {"argument_bytes": 1e9, "temp_bytes": 2e9},
        "collectives": {"all-reduce": 5e9, "_counts": {}},
    }
    base.update(kw)
    return base


class TestRooflineAlgebra:
    def test_terms(self):
        r = analyze(_cell())
        flops = 6e9 * 4096 * 256
        assert r.compute_s == pytest.approx(flops / (256 * PEAK_FLOPS))
        assert r.memory_s == pytest.approx((1e9 + 2 * 2e9) / HBM_BW)
        assert r.collective_s == pytest.approx(5e9 / NVLINK_BW)
        # compute 0.0254 s > collective 0.0111 s > memory 0.0015 s
        assert r.bound == "compute"
        assert (PEAK_FLOPS, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)

    def test_model_flops_train_vs_decode(self):
        train = analyze(_cell())
        dec = analyze(_cell(shape="decode_32k", kind="decode",
                            corrected={"flops_global": 1e12}))
        assert train.model_flops == pytest.approx(6 * 1e9 * 4096 * 256)
        assert dec.model_flops == pytest.approx(2 * 1e9 * 128)

    def test_decode_ideal_is_resident_streaming(self):
        r = analyze(_cell(shape="decode_32k", kind="decode",
                          corrected={"flops_global": 1e12},
                          memory={"argument_bytes": 8e9, "temp_bytes": 0},
                          collectives={"all-reduce": 1e9, "_counts": {}}))
        ideal = 8e9 / HBM_BW
        assert r.roofline_frac == pytest.approx(
            ideal / max(r.compute_s, r.memory_s, r.collective_s))

    def test_frac_capped_at_one(self):
        r = analyze(_cell(memory={"argument_bytes": 1e15, "temp_bytes": 0},
                          collectives={"_counts": {}}))
        assert r.roofline_frac <= 1.0


def test_cells_and_inputs_match_the_reference():
    """``all_cells``, ``PROFILES``, ``SHAPES``, every cell's abstract
    inputs (shapes and dtypes, bfloat16 against the reference's) and
    the batch specs of a (16, 16) policy equal the reference's."""
    from repro.launch import specs as ref

    assert specs.all_cells() == ref.all_cells()
    assert specs.ARCH_IDS == ref.ARCH_IDS
    assert {k: vars(v) for k, v in specs.SHAPES.items()} == {
        k: vars(v) for k, v in ref.SHAPES.items()}
    assert {k: vars(v) for k, v in specs.PROFILES.items()} == {
        k: vars(v) for k, v in ref.PROFILES.items()}
    dt = {"bfloat16": torch.bfloat16, "int32": torch.int32}
    for arch, shape in specs.all_cells():
        got = specs.input_specs(arch, shape)
        want = ref.input_specs(arch, shape)
        flat_got = _flat(got)
        flat_want = _flat(want)
        assert set(flat_got) == set(flat_want), (arch, shape)
        for k, t in flat_got.items():
            w = flat_want[k]
            assert tuple(t.shape) == tuple(w.shape), (arch, shape, k)
            assert t.dtype == dt[str(w.dtype)], (arch, shape, k)
            assert t.device.type == "meta"
    pol = ShardingPolicy.for_mesh(make_mesh(16, 16, devices=["meta"] * 256))
    for arch in ("stablelm-3b", "whisper-small", "paligemma-3b"):
        cfg = get_tiny(arch)
        for B in (256, 1):
            got = specs.batch_partition_specs(cfg, pol, B)
            assert {k: tuple(v) for k, v in got.items()} == {
                k: (("data" if B == 256 else None),) + (None,) * (
                    1 if k == "tokens" else 2) for k in got}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


SHAPES = {"train": specs.Shape("t", "train", 16, 8),
          "prefill": specs.Shape("p", "prefill", 16, 4),
          "decode": specs.Shape("d", "decode", 16, 4)}
PROFILE = specs.RunProfile(microbatches=2)


def trace(arch, kind, dp, tp, cfg=None):
    """``_trace_cell`` of tiny ``arch`` at the cell set-up over a (dp, tp)
    mesh of ``meta`` positions ((1, 1): one device)."""
    cfg0 = cfg or get_tiny(arch)
    mesh = make_mesh(dp, tp, devices=["meta"] * (dp * tp))
    shape = SHAPES[kind]
    if dp * tp == 1:
        c, pol = cfg0, ShardingPolicy.single()
    else:
        c, pol, _ = dryrun.cell_policy(cfg0, mesh, False, shape.global_batch)
    if cfg is not None:
        c = cfg
    return c, pol, dryrun._trace_cell(c, shape, PROFILE, mesh, pol)


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", ["stablelm-3b", "olmoe-1b-7b",
                                  "hymba-1.5b", "deepseek-v3-671b"])
def test_traces_every_kind(arch, kind):
    """Every family's train, prefill and decode trace on meta tensors at
    (1, 1) and (2, 2): FLOPs counted, collectives only over the mesh,
    the argument bytes the largest position's parts' bytes."""
    for dp, tp in ((1, 1), (2, 2)):
        cfg, pol, got = trace(arch, kind, dp, tp)
        assert got["flops_global"] > 0
        assert got["memory"]["temp_bytes"] > 0
        coll = {k: v for k, v in got["collectives"].items()
                if k != "_counts"}
        assert (dp * tp > 1) == bool(coll), coll
        if dp * tp > 1:
            assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
        assert got["trace_s"] >= 0


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _flat(tree).values())


def test_argument_bytes_are_the_parts_bytes():
    """One device holds every byte of the parameters (and the optimizer
    state for train, the cache for decode); over (2, 2) the largest
    position holds its parts' bytes."""
    cfg = get_tiny("stablelm-3b")
    p = pm.abstract_params(cfg)
    _, _, tr = trace("stablelm-3b", "train", 1, 1)
    state = abstract_state(p, AdamWConfig())
    assert tr["memory"]["argument_bytes"] == _bytes(p) + _bytes(
        {"m": state["m"], "v": state["v"]}) + 4
    _, _, de = trace("stablelm-3b", "decode", 1, 1)
    cache = pm.abstract_cache(cfg, 4, 16)
    assert de["memory"]["argument_bytes"] == _bytes(p) + _bytes(cache)
    _, _, pf = trace("stablelm-3b", "prefill", 1, 1)
    assert pf["memory"]["argument_bytes"] == _bytes(p)
    c2, pol, pf2 = trace("stablelm-3b", "prefill", 2, 2)
    sp = pm.shard_params(c2, pm.abstract_params(c2), pol)
    g = sm.mesh_grid(pol)
    want = max(sum(x.parts[i, t].numel() * x.parts[i, t].element_size()
                   for x in _flat(sp).values()) for i, t in g.coords())
    assert pf2["memory"]["argument_bytes"] == want


def test_temp_bytes_leave_out_the_arguments():
    """A decode step over a 4096-slot cache writes the cache in place:
    its views and writes are the arguments', not temporary bytes; a
    position's temporaries hold the grouped einsum's copy of its
    values (B·T·K·hd bfloat16), not the whole cache."""
    shape = specs.Shape("d", "decode", 4096, 32)
    for dp, tp in ((1, 1), (2, 2)):
        mesh = make_mesh(dp, tp, devices=["meta"] * (dp * tp))
        cfg = get_tiny("stablelm-3b")
        pol = (ShardingPolicy.single() if dp * tp == 1 else
               dryrun.cell_policy(cfg, mesh, False, 32)[1])
        got = dryrun._trace_cell(cfg, shape, PROFILE, mesh, pol)["memory"]
        B, K = 32 // dp, cfg.num_kv_heads // tp
        copy = B * 4096 * K * cfg.resolved_head_dim * 2
        cache = 2 * cfg.num_layers * copy
        assert copy <= got["temp_bytes"] < cache / 2, (dp, tp, got)
        assert got["argument_bytes"] > cache


def dense_prefill_flops(cfg, B, S) -> int:
    """2·N·D of every projection and MLP product, the full S² of the
    plain attention's scores and P·V, and the last position's logits."""
    p = pm.abstract_params(cfg)["blocks"]
    per_tok = sum(v[0].numel() for part in ("attn", "mlp")
                  for k, v in p[part].items() if k.startswith("w"))
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    attn = 2 * (2 * B * H * S * S * hd)
    return cfg.num_layers * (2 * B * S * per_tok + attn) \
        + 2 * B * cfg.d_model * cfg.vocab_size


def test_dense_prefill_flops_are_analytic_and_mesh_invariant():
    cfg, pol, _ = trace("stablelm-3b", "prefill", 2, 2)
    want = dense_prefill_flops(cfg, 4, 16)
    for dp, tp in ((1, 1), (2, 2), (1, 2)):
        _, _, got = trace("stablelm-3b", "prefill", dp, tp, cfg=cfg)
        assert got["flops_global"] == want, (dp, tp)


def test_collective_tally_at_1x2_by_hand():
    """stablelm-tiny at (1, 2), no data ranks so no FSDP gather: each
    layer's attention and MLP outputs and the embedding are all-reduced
    (twice the (B, S, D) result's bytes at each of the 2 positions),
    the logits all-gathered (the whole (B, 1, V) at each position);
    per device the sums over the 2 positions halved. bfloat16."""
    for kind, S in (("prefill", 16), ("decode", 1)):
        cfg, _, got = trace("stablelm-3b", kind, 1, 2)
        B, D, V, L = 4, cfg.d_model, cfg.vocab_size, cfg.num_layers
        coll = got["collectives"]
        assert coll["all-reduce"] == (2 * L + 1) * 2 * B * S * D * 2
        assert coll["all-gather"] == B * V * 2
        assert coll["_counts"] == {"all-reduce": 2 * (2 * L + 1),
                                   "all-gather": 2}
        assert set(coll) == {"all-reduce", "all-gather", "_counts"}


def test_tally_is_off_outside_the_dry_run():
    assert sm.TALLY is None
    with sm.tally_collectives() as t:
        assert sm.TALLY is t
    assert sm.TALLY is None


def test_shape_cache_changes_no_count(monkeypatch):
    """The trace with ``ShapeCache`` gives the counts of the trace that
    runs every op's meta kernel."""
    with_cache = trace("stablelm-3b", "train", 2, 2)[2]

    class NoCache(dryrun.ShapeCache):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(dryrun, "ShapeCache", NoCache)
    without = trace("stablelm-3b", "train", 2, 2)[2]
    for k in ("flops_global", "memory", "collectives"):
        assert with_cache[k] == without[k], k


def test_replicated_batch_fallback():
    """A batch of 1 over 2 data ranks: the reference's fallback
    (``dp_axes`` empty, parameters FSDP over 'data'): both data ranks
    hold the whole batch, and the decode step's logits are one
    device's."""
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    cfg0 = get_tiny("hymba-1.5b")
    cfg, pol, _ = dryrun.cell_policy(cfg0, mesh, False, 1)
    assert pol.dp_axes == () and pol.fsdp_axes == ("data",)
    g = sm.mesh_grid(pol)
    assert g.replicas and (g.dp, g.tp) == (2, 2)
    p = pm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = {"tokens": torch.randint(1, cfg.vocab_size, (1, 8), generator=gen)}
    want, c1 = pm.prefill(cfg, p, toks, max_seq=12, attn_impl="ref")
    got, c2 = pm.prefill(cfg, pm.shard_params(cfg, p, pol), toks,
                         max_seq=12, attn_impl="ref", policy=pol)
    assert c2["k"].parts[0, 0].shape[1] == 1
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


# --- Q_CHUNK against the reference's knob ---


@pytest.mark.parametrize("mode", ["triangle", "scan"])
@pytest.mark.parametrize("arch,window", [("stablelm-3b", 0),
                                         ("hymba-1.5b", 16),
                                         ("deepseek-v3-671b", 0)])
def test_q_chunk_matches_the_reference(monkeypatch, arch, window, mode):
    """``Q_CHUNK`` = 4 over S = 16 in both modes (monkeypatched in both
    packages): the plain prefill attention (and MLA's) of layer 0
    within 1e-5 of the reference's; the unchunked answer within 1e-5
    too."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_tiny as ref_tiny
    from repro.models import layers as ref_layers
    from repro.sharding import ShardingPolicy as RefPolicy

    chunk, B, S = 4, 2, 16
    cfg = get_tiny(arch)
    rcfg = ref_tiny(arch)
    pp = pm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    name = "mla" if cfg.use_mla else "attn"
    pl = {k: v[0] for k, v in pp["blocks"][name].items()}
    rl = {k: jnp.asarray(v.numpy()) for k, v in pl.items()}
    xt = torch.as_tensor(x)

    def port():
        if cfg.use_mla:
            return port_layers.mla_block(cfg, pl, xt)[0]
        return port_layers.attention_block(cfg, pl, xt, "ref", window)[0]

    def ref():
        if cfg.use_mla:
            return ref_layers.mla_block(rcfg, RefPolicy.single(), rl,
                                        jnp.asarray(x), pos)
        return ref_layers.attention_block(rcfg, RefPolicy.single(), rl,
                                          jnp.asarray(x), pos)

    plain = port()
    for mod in (ref_layers, port_layers):
        monkeypatch.setattr(mod, "Q_CHUNK", chunk)
        monkeypatch.setattr(mod, "Q_CHUNK_MODE", mode)
    want = np.asarray(jax.jit(ref)())
    got = port()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5, rtol=0)


def _score_flops(S, chunk, mode):
    cfg = get_tiny("stablelm-3b")
    p = {k: v[0] for k, v in pm.abstract_params(cfg)["blocks"]["attn"]
         .items()}
    x = torch.empty(1, S, cfg.d_model, device="meta", dtype=torch.bfloat16)
    from torch.utils.flop_counter import FlopCounterMode

    saved = port_layers.Q_CHUNK, port_layers.Q_CHUNK_MODE
    port_layers.Q_CHUNK, port_layers.Q_CHUNK_MODE = chunk, mode
    try:
        with FlopCounterMode(display=False) as fc:
            port_layers.attention_block(cfg, p, x, "ref")
    finally:
        port_layers.Q_CHUNK, port_layers.Q_CHUNK_MODE = saved
    proj = 2 * S * sum(v.numel() for v in p.values())
    return fc.get_total_flops() - proj, cfg


def test_triangle_counts_causal_half_the_scores():
    """S = 64 in blocks of 16: "triangle" scores and P·V over keys [0,
    (i + 1)·16) of block i, sum_i (i + 1) = 10 of 16 blocks' worth (S²/2
    plus the diagonal blocks' half); "scan" and no chunking the full
    S²."""
    S, bq = 64, 16
    full, cfg = _score_flops(S, 0, "triangle")
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    assert full == 2 * 2 * H * S * S * hd
    assert _score_flops(S, bq, "scan")[0] == full
    tri = _score_flops(S, bq, "triangle")[0]
    nb = S // bq
    assert tri == 2 * 2 * H * hd * bq * bq * nb * (nb + 1) // 2
    assert tri == pytest.approx(full / 2 + full / (2 * nb))


# --- the sweep and the module ---


def test_sweep_skips_existing_and_records_failures(tmp_path, monkeypatch,
                                                   capsys):
    """Two cells: one already written (skipped), one whose command fails
    (``<cell>.FAILED`` with its stderr tail); a rerun skips the first
    and retries the second."""
    cells = [("stablelm-3b", "train_4k"), ("stablelm-3b", "decode_32k")]
    monkeypatch.setattr(sweep, "all_cells", lambda: cells)
    ran = []

    def command(arch, shape, mesh, out, probe):
        ran.append((arch, shape, mesh))
        return [sys.executable, "-c",
                "import sys; sys.stderr.write('boom ' * 3); sys.exit(3)"]

    monkeypatch.setattr(sweep, "cell_command", command)
    sweep.cell_path(tmp_path, *cells[0], "single").write_text("{}")
    sweep.run(str(tmp_path), ["single"])
    assert ran == [("stablelm-3b", "decode_32k", "single")]
    failed = sweep.cell_path(tmp_path, *cells[1], "single").with_suffix(
        ".FAILED")
    assert failed.read_text() == "boom " * 3
    assert "1 cells to run" in capsys.readouterr().out
    sweep.run(str(tmp_path), ["single"])
    assert len(ran) == 2


def test_run_cell_writes_what_load_all_reads(tmp_path, monkeypatch):
    """``run_cell``'s JSON (the production mesh swapped for a (2, 2) one
    and the config for the tiny one, to stay small) carries the keys
    ``roofline.analyze`` reads; ``load_all`` and ``table`` read it."""
    monkeypatch.setattr(dryrun, "get_config", get_tiny)
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod, devices: make_mesh(
                            2, 2, devices=["meta"] * 4))
    monkeypatch.setattr(dryrun, "SHAPES", {"decode_32k": SHAPES["decode"]})
    out = dryrun.run_cell("stablelm-3b", "decode_32k", False, str(tmp_path),
                          verbose=False)
    d = json.loads((tmp_path / "stablelm-3b__decode_32k__single.json")
                   .read_text())
    assert d["corrected"]["flops_global"] == out["corrected"]["flops_global"]
    rows = load_all(str(tmp_path))
    assert len(rows) == 1 and rows[0].chips == 4
    assert "stablelm-3b" in table(rows)


def test_import_changes_no_global_state():
    """Importing ``repro_torch.launch.dryrun`` (and the sweep and the
    roofline) leaves the environment, ``Q_CHUNK``, the tally, torch's
    default dtype, grad mode and dispatch modes as they were."""
    code = """
import os, sys, torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from repro_torch.models import layers
from repro_torch.sharding import model as sm
def snap():
    return (dict(os.environ), layers.Q_CHUNK, layers.Q_CHUNK_MODE,
            sm.TALLY, torch.get_default_dtype(), torch.is_grad_enabled(),
            _get_current_dispatch_mode(), torch.get_num_threads())
before = snap()
import repro_torch.launch.dryrun, repro_torch.launch.sweep
import repro_torch.analysis.roofline
assert snap() == before, (snap(), before)
assert "jax" not in sys.modules
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_bf16_ssd_promotes_as_the_reference():
    """``ssd_chunked`` on bfloat16 inputs beside float32 decays (the
    dry run's bfloat16 parameters): the reference's einsums promote to
    float32; the port raised (``bmm`` of bfloat16 and float32) and now
    promotes too, within float32 rounding of the reference."""
    import jax.numpy as jnp
    from repro.models.layers import ssd_chunked as ref

    rng = np.random.default_rng(0)
    b, s, h, p, n, chunk = 2, 24, 3, 8, 4, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)

    def bf(a):
        return jnp.asarray(a, jnp.bfloat16)

    def tb(a):
        return torch.as_tensor(a).to(torch.bfloat16)

    yr, sr = ref(bf(x), bf(dt), jnp.asarray(A), bf(B), bf(C), chunk)
    yp, sp = port_layers.ssd_chunked(tb(x), tb(dt), torch.as_tensor(A),
                                     tb(B), tb(C), chunk)
    assert yp.dtype == torch.float32 and sp.dtype == torch.float32
    yr = np.asarray(yr, dtype=np.float32)
    np.testing.assert_allclose(yp.numpy(), yr, rtol=0,
                               atol=1e-6 * math.ceil(np.abs(yr).max()))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sr), rtol=0,
                               atol=1e-6 * math.ceil(np.abs(sr).max()))
