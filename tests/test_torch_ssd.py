"""The port's SSD scan against the JAX package's, on the CPU.

The port's :func:`repro_torch.kernels.ssd.ssd` (its CPU branch runs the
kernel's plain version, ``ref.ssd_chunked_ref``) against the reference's
``repro.kernels.ssd.ops.ssd`` (the Pallas kernel in interpret mode) on the
reference's four ``SSD_CASES`` (``tests/test_kernels.py:75-80``, the ragged
S = 200 included), with float32 and with bf16 B/C, at the reference's
tolerance 5e-4 (atol and rtol); against the sequential per-token
recurrence at the reference's 1e-4; the wrapper ``ssd_chunked`` on strided
and contiguous [B, H, S, P] against the reference's ``ssd_chunked``; the
model-layout plain scan ``ssd_reference`` and ``segsum_exp`` against the
reference's (``segsum_exp``'s gradient also where the reference's is NaN:
finite, equal to float64's); and the wrapper's rejections.  Inputs come
from numpy seeds and go to both sides as the same values.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.ssd.kernel import ssd_chunked as r_ssd_chunked  # noqa: E402
from repro.kernels.ssd.ops import ssd as r_ssd  # noqa: E402
from repro.models import ssm as r_ssm  # noqa: E402

from repro_torch.kernels.ssd import (  # noqa: E402
    segsum_exp, ssd, ssd_chunked, ssd_chunked_ref, ssd_reference)

# the reference's SSD_CASES: (B, S, H, P, N, chunk); its fourth case draws
# x in bf16 before casting it to float32
SSD_CASES = [(2, 256, 3, 32, 16, 64, "float32"),
             (1, 128, 2, 64, 32, 32, "float32"),
             (2, 200, 2, 32, 16, 64, "float32"),
             (2, 256, 4, 64, 16, 128, "bfloat16")]
TOL = dict(atol=5e-4, rtol=5e-4)


def _inputs(B, S, H, P, N, x_dtype="float32", bc_dtype="float32", seed=0,
            a_scale=0.1):
    """x [B, S, H, P] float32, a [B, S, H] <= 0, B/C [B, S, N] as float32
    numpy arrays (values representable in the stated dtypes)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((B, S, H))) * a_scale).astype(np.float32)
    bm = rng.standard_normal((B, S, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, N)).astype(np.float32)
    if x_dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    if bc_dtype == "bfloat16":
        bm, cm = (np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
                  for v in (bm, cm))
    return x, a, bm, cm


def _port(arrays, bc_dtype):
    x, a, bm, cm = (torch.from_numpy(v) for v in arrays)
    dt = getattr(torch, bc_dtype)
    return x, a, bm.to(dt), cm.to(dt)


def _ref(arrays, bc_dtype):
    x, a, bm, cm = (jnp.asarray(v) for v in arrays)
    dt = getattr(jnp, bc_dtype)
    return x, a, bm.astype(dt), cm.astype(dt)


@pytest.mark.parametrize("bc_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk,x_dtype", SSD_CASES)
def test_ssd_matches_reference(B, S, H, P, N, chunk, x_dtype, bc_dtype):
    arrays = _inputs(B, S, H, P, N, x_dtype, bc_dtype)
    y_want, fs_want = r_ssd(*_ref(arrays, bc_dtype), chunk=chunk)
    y, fs = ssd(*_port(arrays, bc_dtype), chunk=chunk)
    assert y.shape == (B, S, H, P) and fs.shape == (B, H, P, N)
    assert y.dtype == fs.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fs_want), **TOL)


def test_ssd_equals_sequential_recurrence():
    """Chunked SSD == the per-token state recurrence (the reference's
    ``test_ssd_equals_sequential_recurrence`` with numpy inputs)."""
    B, S, H, P, N = 1, 64, 2, 8, 4
    x, a, bm, cm = _inputs(B, S, H, P, N, seed=1, a_scale=0.2)
    y, fs = ssd(*_port((x, a, bm, cm), "float32"), chunk=16)
    state = np.zeros((B, H, P, N))
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        state = state * np.exp(a[:, t])[:, :, None, None] + \
            np.einsum("bhp,bn->bhpn", x[:, t], bm[:, t])
        ys[:, t] = np.einsum("bhpn,bn->bhp", state, cm[:, t])
    np.testing.assert_allclose(y.numpy(), ys, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(fs.numpy(), state, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bc_dtype", ["float32", "bfloat16"])
def test_ssd_chunked_both_layouts_match_reference(bc_dtype):
    """The wrapper on strided [B, H, S, P] views of [B, S, H, P] (as
    ``ssd`` passes them) and on contiguous [B, H, S, P] copies against the
    reference's ``ssd_chunked`` on [BH, S, P]."""
    B, S, H, P, N, Q = 2, 128, 3, 16, 8, 32
    x, a, bm, cm = _inputs(B, S, H, P, N, bc_dtype=bc_dtype, seed=2)
    xf = x.transpose(0, 2, 1, 3).reshape(B * H, S, P)
    af = a.transpose(0, 2, 1).reshape(B * H, S)
    _, _, rbm, rcm = _ref((x, a, bm, cm), bc_dtype)
    y_want, fs_want = r_ssd_chunked(jnp.asarray(xf), jnp.asarray(af), rbm,
                                    rcm, chunk=Q, n_heads=H)
    px, pa, pbm, pcm = _port((x, a, bm, cm), bc_dtype)
    views = px.transpose(1, 2), pa.transpose(1, 2)
    for xv, av in (views, tuple(v.contiguous() for v in views)):
        y, fs = ssd_chunked(xv, av, pbm, pcm, chunk=Q, n_heads=H)
        assert y.shape == (B, H, S, P) and fs.shape == (B, H, N, P)
        np.testing.assert_allclose(y.reshape(B * H, S, P).numpy(),
                                   np.asarray(y_want), **TOL)
        np.testing.assert_allclose(fs.reshape(B * H, N, P).numpy(),
                                   np.asarray(fs_want), **TOL)


def test_plain_versions_agree():
    """The kernel's plain version (rows of [BH, S, P]) and the model-layout
    scan ``ssd_reference`` compute the same function."""
    B, S, H, P, N, Q = 2, 96, 2, 8, 8, 32
    x, a, bm, cm = _port(_inputs(B, S, H, P, N, seed=3), "float32")
    y, fs = ssd_reference(x, a, bm, cm, Q)
    yc, fsc = ssd_chunked_ref(x.transpose(1, 2).reshape(B * H, S, P),
                              a.transpose(1, 2).reshape(B * H, S), bm, cm,
                              chunk=Q, n_heads=H)
    np.testing.assert_allclose(yc.reshape(B, H, S, P).transpose(1, 2).numpy(),
                               y.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(fsc.reshape(B, H, N, P).transpose(-1, -2)
                               .numpy(), fs.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_reference_matches_reference(with_init):
    B, S, H, P, N, Q = 2, 64, 2, 8, 16, 16
    arrays = _inputs(B, S, H, P, N, seed=4)
    init = np.random.default_rng(5).standard_normal(
        (B, H, P, N)).astype(np.float32) if with_init else None
    y_want, fs_want = r_ssm.ssd_reference(
        *_ref(arrays, "float32"), chunk=Q,
        init_state=None if init is None else jnp.asarray(init))
    y, fs = ssd_reference(*_port(arrays, "float32"), Q,
                          None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fs_want), atol=1e-5,
                               rtol=1e-5)


def test_segsum_exp_matches_reference():
    a = -np.abs(np.random.default_rng(6).standard_normal((3, 2, 16))
                ).astype(np.float32)
    np.testing.assert_allclose(segsum_exp(torch.from_numpy(a)).numpy(),
                               np.asarray(r_ssm.segsum_exp(jnp.asarray(a))),
                               atol=1e-6, rtol=1e-6)


def test_segsum_exp_gradient_is_finite_where_the_reference_overflows():
    """A chunk of 128 steps of log decay about -1.4, as mamba2's full width
    gives (the largest sum above the diagonal 174): the values equal the
    reference's ``where(tril, exp(diff), 0)`` bit for bit, and the
    gradient is finite and equal to float64's, where the reference's is
    NaN (its exp overflows above the diagonal: 0 * inf)."""
    rng = np.random.default_rng(8)
    a = -(1.4 + 0.1 * rng.random((2, 3, 128))).astype(np.float32)
    t = torch.from_numpy(a).requires_grad_()
    got = segsum_exp(t)
    cum = t.detach().cumsum(-1)
    diff = cum[..., :, None] - cum[..., None, :]
    tril = torch.ones((128, 128), dtype=torch.bool).tril()
    assert float(diff.max()) > 88.8                 # exp overflows float32
    assert torch.equal(got.detach(), torch.where(tril, torch.exp(diff),
                                                 torch.zeros(())))
    w = np.random.default_rng(9).standard_normal(got.shape)
    (g,) = torch.autograd.grad((got * torch.from_numpy(w).float()).sum(), t)
    t64 = torch.from_numpy(a.astype(np.float64)).requires_grad_()
    (g64,) = torch.autograd.grad((segsum_exp(t64) * torch.from_numpy(w)
                                  ).sum(), t64)
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(g.numpy(), g64.numpy(), rtol=1e-4,
                               atol=1e-4 * float(g64.abs().max()))
    r_g = jax.grad(lambda x: (r_ssm.segsum_exp(x) * w).sum())(
        jnp.asarray(a))
    assert np.isnan(np.asarray(r_g)).any()


def test_ssd_under_grad_raises():
    x, a, bm, cm = _port(_inputs(1, 32, 2, 8, 4, seed=7), "float32")
    x.requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        ssd(x, a, bm, cm, chunk=16)
    with torch.no_grad():
        y, _ = ssd(x, a, bm, cm, chunk=16)
    assert y.shape == x.shape


@pytest.mark.parametrize("case", ["ragged", "x bf16", "a bf16", "B/C apart",
                                  "heads", "B rows", "device", "rows flat"])
def test_ssd_chunked_rejects(case):
    x, a, bm, cm = _port(_inputs(2, 64, 2, 8, 4, seed=8), "float32")
    xf, af = x.transpose(1, 2), a.transpose(1, 2)
    kw = dict(chunk=32, n_heads=2)
    err = ValueError
    if case == "ragged":
        kw["chunk"] = 48
    elif case == "x bf16":
        xf, err = xf.bfloat16(), TypeError
    elif case == "a bf16":
        af, err = af.bfloat16(), TypeError
    elif case == "B/C apart":
        cm, err = cm.bfloat16(), TypeError
    elif case == "heads":
        kw["n_heads"] = 3
    elif case == "B rows":
        bm, cm = bm[:1], cm[:1]
    elif case == "rows flat":
        xf, af = xf.reshape(4, 64, 8), af.reshape(4, 64)
    else:
        xf, af, bm, cm = (t.to("meta") for t in (xf, af, bm, cm))
    with pytest.raises(err):
        ssd_chunked(xf, af, bm, cm, **kw)
