"""The port's model-tier sharding policy (``repro_torch.sharding.policy``),
its parameter and cache specs and its meshes, against the reference's,
in-process: the reference's ``ShardingPolicy`` runs on a
``jax.sharding.AbstractMesh`` (no devices), the port's on a
``ModelMesh`` of repeated CPU devices of the same shape. Specs are held
equal entry by entry, for every logical axis under every policy
variant, and for every parameter and cache leaf of every configuration
in ``ARCHS``; ``abstract_params`` / ``abstract_cache`` shapes and
dtypes likewise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS, get_config  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro.models.lm import abstract_cache as ref_abstract_cache  # noqa: E402
from repro.models.lm import cache_specs as ref_cache_specs  # noqa: E402
from repro.sharding.policy import ShardingPolicy as RefPolicy  # noqa: E402
from repro.sharding.policy import spec_tree as ref_spec_tree  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.models import params as port_params  # noqa: E402
from repro_torch.sharding import model as sm  # noqa: E402
from repro_torch.sharding.policy import (  # noqa: E402
    PartitionSpec,
    Placement,
    ShardingPolicy,
    spec_tree,
)

LOGICAL = (None, "batch", "embed", "heads", "kv_heads", "mlp", "vocab",
           "expert", "seq", "kv_seq", "layers", "head_dim", "state", "conv")
# (mesh shape or None for single(), for_mesh keywords, replace keywords)
VARIANTS = {
    "single": (None, {}, {}),
    "dp2_tp4": ((2, 4), {}, {}),
    "pods": ((2, 2, 4), {}, {}),
    "dp_over_tp": ((2, 4), {}, {"dp_over_tp": True}),
    "ep_over_dp": ((2, 4), {}, {"ep_over_dp": True}),
    "no_fsdp": ((2, 4), {"fsdp_params": False}, {}),
    "seq_parallel": ((2, 4), {"seq_parallel": True}, {}),
    "shard_cache_seq": ((2, 4), {}, {"shard_cache_seq": True}),
    "kv_replicated": ((2, 4), {"shard_kv_heads": False}, {}),
    "tp_only": ((1, 4), {}, {}),
}
ARCH_IDS = [a.replace("_", "-").replace("qwen2-5", "qwen2.5")
            .replace("hymba-1-5b", "hymba-1.5b") for a in ARCHS]


def policies(variant):
    """(reference policy, port policy) of ``variant``."""
    shape, kw, rep = VARIANTS[variant]
    if shape is None:
        return RefPolicy.single(), ShardingPolicy.single()
    axes = (("pod", "data", "model") if len(shape) == 3
            else ("data", "model"))
    ref = RefPolicy.for_mesh(AbstractMesh(shape, axes), **kw)
    n = int(np.prod(shape))
    if len(shape) == 3:
        mesh = port_mesh.make_mesh(shape[1], shape[2], pods=shape[0],
                                   devices=["cpu"] * n)
    else:
        mesh = port_mesh.make_mesh(*shape, devices=["cpu"] * n)
    port = ShardingPolicy.for_mesh(mesh, **kw)
    if rep:
        ref, port = ref.replace(**rep), port.replace(**rep)
    return ref, port


def same_spec(port, ref) -> bool:
    return isinstance(port, PartitionSpec) and tuple(port) == tuple(ref)


def same_specs(port: dict, ref: dict, path=""):
    assert set(port) == set(ref), path
    for k in ref:
        if isinstance(ref[k], dict):
            same_specs(port[k], ref[k], f"{path}/{k}")
        else:
            assert same_spec(port[k], ref[k]), (f"{path}/{k}", port[k],
                                                ref[k])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_every_logical_axis_maps_as_the_reference(variant):
    ref, port = policies(variant)
    for a in LOGICAL:
        assert same_spec(port.spec(a), ref.spec(a)), (a, port.spec(a))
    assert same_spec(port.spec(*LOGICAL), ref.spec(*LOGICAL))
    assert port.tp_size() == ref.tp_size()
    assert port.dp_size() == ref.dp_size()
    assert port.active == ref.active
    assert (port.dp_axes, port.fsdp_axes, port.tp_axis) == (
        ref.dp_axes, ref.fsdp_axes, ref.tp_axis)
    x = torch.zeros(2)
    assert port.shard(x, "batch") is x  # placement is explicit
    if port.mesh is None:
        assert port.named_sharding("batch") is None
    else:
        ns = port.named_sharding("batch", "embed")
        assert isinstance(ns, Placement) and ns.mesh is port.mesh
        assert same_spec(ns.spec, ref.spec("batch", "embed"))


@pytest.mark.parametrize("variant", ("single", "dp2_tp4", "pods",
                                     "ep_over_dp", "no_fsdp",
                                     "kv_replicated", "dp_over_tp"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, variant):
    ref, port = policies(variant)
    want = ref_params.param_specs(get_config(arch), ref)
    got = port_params.param_specs(port_config(arch), port)
    same_specs(got, want)
    axes = port_params.param_axes(port_config(arch))
    same_specs(spec_tree(axes, port),
               ref_spec_tree(ref_params.param_axes(get_config(arch)), ref))
    if port.mesh is not None:
        placed = port_params.param_shardings(port_config(arch), port)
        assert placed["embed"] == Placement(port.mesh,
                                            port.spec("vocab", "embed"))


@pytest.mark.parametrize("variant", ("single", "dp2_tp4", "pods",
                                     "shard_cache_seq", "kv_replicated",
                                     "dp_over_tp", "tp_only"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_the_reference(arch, variant):
    ref, port = policies(variant)
    want = ref_cache_specs(get_config(arch), 16, 128, ref)
    got = port_lm.cache_specs(port_config(arch), 16, 128, port)
    same_specs(got, want)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_cache(arch):
    """Shapes and dtypes of every leaf (meta tensors: no memory)."""
    ref = ref_params.abstract_params(get_config(arch))
    got = port_params.abstract_params(port_config(arch))

    def walk(g, r, path=""):
        assert set(g) == set(r), path
        for k in r:
            if isinstance(r[k], dict):
                walk(g[k], r[k], f"{path}/{k}")
                continue
            assert g[k].device.type == "meta", (path, k)
            assert tuple(g[k].shape) == tuple(r[k].shape), (path, k)
            assert _dtype_name(g[k].dtype) == str(r[k].dtype), (path, k)

    walk(got, ref)
    rc = ref_abstract_cache(get_config(arch), 4, 64)
    pc = port_lm.abstract_cache(port_config(arch), 4, 64)
    assert set(pc) == set(rc)
    for k in rc:
        assert tuple(pc[k].shape) == tuple(rc[k].shape), k
        assert _dtype_name(pc[k].dtype) == str(rc[k].dtype), k
        assert pc[k].device.type == "meta"
    f32 = port_params.abstract_params(port_config(arch), torch.float32)
    assert f32["embed"].dtype == torch.float32
    assert jnp.dtype(ref_params.abstract_params(
        get_config(arch), jnp.float32)["embed"].dtype) == jnp.float32


def test_make_mesh_shapes_and_names():
    m = port_mesh.make_mesh(2, 4, devices=["cpu"] * 8)
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 2, "model": 4} and m.size == 8
    assert m.devices.shape == (2, 4) and m.shared
    m3 = port_mesh.make_mesh(2, 2, pods=2, devices=["cpu"] * 8)
    assert m3.axis_names == ("pod", "data", "model")
    assert m3.shape == {"pod": 2, "data": 2, "model": 2}
    one = port_mesh.single_device_mesh("cpu")
    assert one.shape == {"data": 1, "model": 1} and one.size == 1
    assert not ShardingPolicy.for_mesh(one).active
    prod = port_mesh.make_production_mesh(devices=["cpu"] * 256)
    assert prod.shape == {"data": 16, "model": 16}
    multi = port_mesh.make_production_mesh(multi_pod=True,
                                           devices=["cpu"] * 512)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    # the reference's production mesh shapes
    assert tuple(prod.shape.values()) == (16, 16)


def test_make_mesh_never_falls_to_the_cpu(monkeypatch):
    """Without ``devices=`` the mesh takes distinct CUDA cards and raises,
    naming how many it needs and found, when there are fewer."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices, found 0"):
        port_mesh.make_mesh(2, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, found 1"):
        port_mesh.make_mesh(1, 2)
    m = port_mesh.make_mesh(1, 1)
    assert m.devices[0, 0] == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="devices= gives 3"):
        port_mesh.make_mesh(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        port_mesh.make_mesh(0, 2, devices=[])
    with pytest.raises(ValueError, match="256 entries"):
        port_mesh.make_production_mesh()


def test_kv_range_layouts():
    """The KV heads each tensor-parallel rank reads: whole groups when
    the ranks hold several (olmoe's group 1, starcoder2 at tp 2), one
    head shared by the ranks inside a group (starcoder2's 2 KV heads
    over tp 4); a rank straddling groups reads each group it touches
    (query heads in ceil chunks), and a rank with no query heads none;
    a head count that is no multiple of the KV heads raises."""
    assert [sm.kv_range(16, 16, 2, t) for t in range(2)] == [(0, 8),
                                                             (8, 16)]
    assert [sm.kv_range(24, 2, 4, t) for t in range(4)] == [
        (0, 1), (0, 1), (1, 2), (1, 2)]
    assert [sm.kv_range(24, 2, 2, t) for t in range(2)] == [(0, 1), (1, 2)]
    # 2 query heads a rank, groups of 3
    assert [sm.kv_range(6, 2, 3, t) for t in range(3)] == [
        (0, 1), (0, 2), (1, 2)]
    # 6 heads over 4 ranks: 2, 2, 2 and none
    assert [sm.kv_range(6, 2, 4, t) for t in range(4)] == [
        (0, 1), (0, 2), (1, 2), (2, 2)]
    with pytest.raises(ValueError):
        sm.kv_range(5, 2, 2, 0)


def test_dedupe_spec_keeps_the_first_use():
    assert tuple(sm.dedupe_spec(PartitionSpec(None, ("data", "model"),
                                              "data", None))) == (
        None, ("data", "model"), None, None)
    assert tuple(sm.dedupe_spec(PartitionSpec("data", "model",
                                              "model"))) == (
        "data", "model", None)
