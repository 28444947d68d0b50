"""The port's SSD (Mamba-2 state-space duality) against the reference's,
on inputs made from a numpy seed: K9's plain version ``ssd_chunk_ref``
against the reference's Pallas ``ssd_chunk_kernel`` in interpret mode
(all four outputs), ``ops.ssd(impl="ref")`` against the reference's
``ops.ssd`` at ``impl="interpret"`` and ``"jnp"``, ``ssd_chunked`` and
``ssd_reference`` against the reference's, ``causal_conv1d``, the final
state continued by one step, and the strong-decay case (A in [-16, -1],
large dt) with no NaN.

Tolerances, float32: for the chunk step and the strong-decay case
``ssd_cases.tolerance`` relative to the largest magnitude of each
output (1e-5 for sums taken in other orders, plus 2^-23 of the largest
|cum|, which the decay weights exp(cum_i - cum_j) inherit as relative
rounding; the reference's cumsum is not sequential); 1e-4 absolute and
relative where the sequential oracle (an s-step recurrence) is the
yardstick, as the reference's own tests hold it; the conv bit for bit
(the same multiply-adds in the same order).

K9 itself runs only on the card (``tests/test_torch_cuda.py``); here
``impl="kernel"`` on a CPU tensor must raise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd import ops as ref_ops  # noqa: E402
from repro.kernels.ssd.ssd import ssd_chunk_kernel  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.kernels import ssd_cases as SC  # noqa: E402
from repro_torch.kernels.ssd import ops as port_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import (  # noqa: E402
    ssd_chunk_ref,
    ssd_reference,
)
from repro_torch.models import layers as port_layers  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
# the shapes of tests/test_kernels.py::TestSSDKernel, padded s = 100 too
SHAPES = [(1, 64, 2, 8, 4, 16), (2, 128, 4, 16, 8, 32),
          (1, 100, 2, 8, 16, 32)]


def inputs(seed, b, s, h, p, n, strong=False):
    """x, dt (softplus of a normal), A (negative), B, C as float32 numpy;
    ``strong``: dt = softplus(3 N(0,1)) and A = -U[1, 16], the model's
    init, where exp(cum_i - cum_j) above the diagonal overflows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    z = rng.standard_normal((b, s, h)) * (3.0 if strong else 1.0)
    dt = np.log1p(np.exp(z)).astype(np.float32)
    if strong:
        A = -rng.uniform(1.0, 16.0, h).astype(np.float32)
    else:
        A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, B, C


def t(a):
    return torch.from_numpy(np.asarray(a))


def close_rel(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1.0), err


@pytest.mark.parametrize("strong", (False, True), ids=("mild", "strong"))
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 8, 4, 16), (2, 128, 4, 16, 8, 32), (1, 96, 3, 8, 16, 32)])
def test_chunk_ref_matches_pallas_interpret(b, s, h, p, n, chunk, strong):
    x, dt, A, B, C = inputs(7 + s, b, s, h, p, n, strong)
    want = ssd_chunk_kernel(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                            jnp.asarray(B), jnp.asarray(C), chunk=chunk,
                            interpret=True)
    got = ssd_chunk_ref(t(x), t(dt), t(A), t(B), t(C), chunk)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    tol = SC.tolerance(SC.cum_max(t(dt), t(A), chunk))
    for g, w in zip(got, want):
        close_rel(g, w, tol)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ops_ssd_matches_reference(b, s, h, p, n, chunk):
    x, dt, A, B, C = inputs(11, b, s, h, p, n)
    args = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    y, st = port_ops.ssd(t(x), t(dt), t(A), t(B), t(C), chunk, impl="ref")
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    for impl in ("interpret", "jnp"):
        yr, sr = ref_ops.ssd(*args, chunk=chunk, impl=impl)
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(sr), **TOL)
    auto = port_ops.ssd(t(x), t(dt), t(A), t(B), t(C), chunk)  # CPU: ref
    assert all(torch.equal(a, b_) for a, b_ in zip(auto, (y, st)))
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(ref_layers.ssd_reference(*args)),
                               **TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_chunked_and_sequential_match_reference(b, s, h, p, n, chunk):
    x, dt, A, B, C = inputs(13, b, s, h, p, n)
    args = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    y, st = port_layers.ssd_chunked(t(x), t(dt), t(A), t(B), t(C), chunk)
    yr, sr = ref_layers.ssd_chunked(*args, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), **TOL)
    seq = ssd_reference(t(x), t(dt), t(A), t(B), t(C))
    np.testing.assert_allclose(seq.numpy(),
                               np.asarray(ref_layers.ssd_reference(*args)),
                               **TOL)
    np.testing.assert_allclose(y.numpy(), seq.numpy(), **TOL)
    assert port_layers.ssd_reference is ssd_reference


@pytest.mark.parametrize("cw,S,Cdim", [(4, 1, 5), (4, 13, 24), (2, 7, 3)])
def test_causal_conv1d_matches_reference(cw, S, Cdim):
    rng = np.random.default_rng(cw * 100 + S)
    x = rng.standard_normal((2, S, Cdim)).astype(np.float32)
    w = rng.standard_normal((cw, Cdim)).astype(np.float32)
    bias = rng.standard_normal(Cdim).astype(np.float32)
    got = port_layers.causal_conv1d(t(x), t(w), t(bias))
    want = ref_layers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(bias))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ("chunked", "ops"))
def test_final_state_matches_decode_continuation(impl):
    """The chunked final state continues exactly via the step form
    (``tests/test_models_smoke.py``'s check, in the port)."""
    b, s, h, p, n, chunk = 1, 16, 2, 4, 8, 8
    x, dt, A, B, C = (t(a) for a in inputs(1, b, s + 1, h, p, n))
    if impl == "chunked":
        _, state = port_layers.ssd_chunked(x[:, :s], dt[:, :s], A,
                                           B[:, :s], C[:, :s], chunk)
    else:
        _, state = port_ops.ssd(x[:, :s], dt[:, :s], A, B[:, :s],
                                C[:, :s], chunk, impl="ref")
    decay = torch.exp(dt[:, s] * A)
    state2 = state * decay[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", x[:, s] * dt[:, s][..., None], B[:, s])
    y_step = torch.einsum("bhpn,bn->bhp", state2, C[:, s])
    y_all = ssd_reference(x, dt, A, B, C)
    np.testing.assert_allclose(y_step.numpy(), y_all[:, s].numpy(), **TOL)


def test_strong_decay_has_no_nan():
    """A = -U[1, 16] and dt = softplus(3 N(0,1)): exp(cum_i - cum_j)
    above the diagonal is inf; it must be selected away, not
    multiplied by 0."""
    b, s, h, p, n, chunk = 2, 128, 4, 16, 16, 64
    x, dt, A, B, C = inputs(5, b, s, h, p, n, strong=True)
    cum = np.cumsum((dt * A).reshape(b, 2, chunk, h), axis=2)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cum[:, :, :, None] - cum[:, :, None])).any()
    for got in ssd_chunk_ref(t(x), t(dt), t(A), t(B), t(C), chunk):
        assert torch.isfinite(got).all()
    y, st = port_ops.ssd(t(x), t(dt), t(A), t(B), t(C), chunk, impl="ref")
    yc, sc = port_layers.ssd_chunked(t(x), t(dt), t(A), t(B), t(C), chunk)
    for a in (y, st, yc, sc):
        assert torch.isfinite(a).all()
    args = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    yr, sr = ref_ops.ssd(*args, chunk=chunk, impl="interpret")
    tol = SC.tolerance(SC.cum_max(t(dt), t(A), chunk))
    close_rel(y, yr, tol)
    close_rel(st, sr, tol)
    close_rel(yc, ref_layers.ssd_chunked(*args, chunk)[0], tol)


def test_kernel_impl_raises_on_cpu():
    x, dt, A, B, C = (t(a) for a in inputs(0, 1, 16, 2, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        port_ops.ssd(x, dt, A, B, C, 8, impl="kernel")
    with pytest.raises(ValueError):
        port_ops.ssd(x, dt, A, B, C, 8, impl="host")
