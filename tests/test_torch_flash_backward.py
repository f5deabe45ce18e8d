"""The port's flash attention backward against the JAX package.

On CPU tensors the backward runs the CUDA kernels' plain version
(``kernels/flash_attention/ref.py:attention_bwd_ref``).  It is held against
the reference's ``flash_bwd`` (the Pallas ``_dq_kernel``/``_dkv_kernel`` in
interpret mode, per-query-head dk/dv summed over each GQA group as the
reference's ``_flash_bwd_rule`` does) on the nine cases of
``tests/test_torch_flash_attention.py`` (the reference's FLASH_CASES and
danube-like ones: head dim 120, group 4, windows 64 and 128), from the same
``o`` and ``lse`` (the reference's forward).  Both sides compute in float32
on the same values (bf16 inputs are widened first on both), so the plain
version is held at atol = rtol = 1e-4, under the reference's own gradient
tolerance of 5e-4; the wrapper ``flash_bwd`` returns the inputs' dtype and
is held at 5e-4 in float32 and at bf16's rounding (2e-2) in bf16.

``flash_attention``'s autograd gradients are held against ``jax.grad`` of
the reference's ``flash_attention`` at ``test_flash_grads_match_ref``'s
shape (``tests/test_kernels.py:49-70``: B 2, S 256, 4/2 heads, D 64), at
its tolerance of 5e-4.  The kernels themselves are held against the plain
version on the card by ``chip_smoke.py`` (*flash_bwd*); here the Python
that surrounds them is: the tile ranges the bf16 kernels walk
(``visible_tiles``, against the mask), the tile constants against the CUDA
source, and the per-row inputs the wrapper prepares.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_bwd as r_flash_bwd  # noqa: E402,E501
from repro.kernels.flash_attention.kernel import flash_fwd as r_flash_fwd  # noqa: E402,E501
from repro.kernels.flash_attention.ops import flash_attention as r_flash_attention  # noqa: E402,E501

from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402

# (BH, query rows per KV row, S, D, window, dtype), as in
# tests/test_torch_flash_attention.py
CASES = [
    (4, 2, 256, 64, 0, "float32"),
    (2, 1, 512, 128, 0, "float32"),
    (4, 4, 256, 64, 128, "float32"),
    (2, 2, 384, 64, 0, "bfloat16"),
    (8, 1, 256, 64, 64, "bfloat16"),
    (8, 4, 256, 120, 64, "float32"),
    (8, 4, 384, 120, 128, "float32"),
    (8, 4, 256, 120, 128, "bfloat16"),
    (8, 4, 384, 120, 64, "bfloat16"),
]
PLAIN_TOL = 1e-4
WRAPPER_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
GRAD_TOL = 5e-4


def _np(x):
    return np.asarray(x, np.float32)


def _inputs(case):
    """q, k, v, do as float32 numpy arrays of the case's shapes."""
    BH, g, S, D, _, _ = case
    rng = np.random.default_rng(0)
    return (rng.standard_normal((BH, S, D), np.float32),
            rng.standard_normal((BH // g, S, D), np.float32),
            rng.standard_normal((BH // g, S, D), np.float32),
            rng.standard_normal((BH, S, D), np.float32))


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The reference's (o, lse) and its group-summed (dq, dk, dv), float32
    numpy."""
    BH, g, S, D, window, dtype = case
    q, k, v, do = (jnp.asarray(x, getattr(jnp, dtype))
                   for x in _inputs(case))
    scale = 1.0 / np.sqrt(D)
    o, lse = r_flash_fwd(q, k, v, scale=scale, window=window)
    dq, dk, dv = r_flash_bwd(q, k, v, o, lse, do, scale=scale,
                             window=window)
    if g > 1:
        dk = dk.reshape(BH // g, g, S, D).sum(1)
        dv = dv.reshape(BH // g, g, S, D).sum(1)
    return tuple(_np(x) for x in (o, lse, dq, dk, dv))


def _port_inputs(case):
    """The case's q, k, v, do in its dtype and the reference's o and lse,
    as torch tensors."""
    dtype = getattr(torch, case[-1])
    o, lse = _reference(case)[:2]
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _inputs(case))
    return q, k, v, torch.tensor(o).to(dtype), torch.tensor(lse), do


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_reference_flash_bwd(case):
    want = _reference(case)[2:]
    got = FR.attention_bwd_ref(*_port_inputs(case), window=case[4])
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=PLAIN_TOL,
                                   rtol=PLAIN_TOL, err_msg=name)


@pytest.mark.parametrize("layout", ["[BH,S,D]", "[B,H,S,D] view"])
@pytest.mark.parametrize("case", CASES[3:], ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_wrapper_matches_reference(case, layout):
    """The entry point on CPU tensors, in both layouts it takes, returns
    the inputs' dtypes and shapes, and launches nothing."""
    BH, g, S, D, window, dtype = case
    q, k, v, o, lse, do = _port_inputs(case)
    if layout != "[BH,S,D]":
        # [B, H, S, D] views of [B, S, H, D] activations, with B = 2 where
        # the KV rows split evenly
        B = 2 if (BH // g) % 2 == 0 else 1

        def view(x):
            return x.reshape(B, -1, S, D).transpose(1, 2).contiguous() \
                .transpose(1, 2)
        q, k, v, o, do = (view(x) for x in (q, k, v, o, do))
        lse = lse.reshape(B, -1, S)
    before = (FK.flash_bwd.launches_dq, FK.flash_bwd.launches_dkv)
    got = FK.flash_bwd(q, k, v, o, lse, do, window=window)
    assert (FK.flash_bwd.launches_dq, FK.flash_bwd.launches_dkv) == before
    tol = WRAPPER_TOL[dtype]
    for name, a, x, b in zip(("dq", "dk", "dv"), got, (q, k, v),
                             _reference(case)[2:]):
        assert a.dtype == x.dtype and a.shape == x.shape, name
        np.testing.assert_allclose(a.float().reshape(b.shape).numpy(), b,
                                   atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("window", [0, 64])
def test_flash_attention_grads_match_reference(window):
    """autograd through ``flash_attention`` against ``jax.grad`` through the
    reference's (its custom VJP: the Pallas backward kernels)."""
    B, S, Hq, Hkv, D = 2, 256, 4, 2, 64
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, S, Hq, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)

    def loss_r(q, k, v):
        return (r_flash_attention(q, k, v, window=window) ** 2).sum()

    want = jax.grad(loss_r, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (FO.flash_attention(qt, kt, vt, window=window) ** 2).sum().backward()
    for name, a, b in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad),
                          want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), _np(b), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_flash_attention_bf16_grads_keep_dtype():
    q = torch.randn(1, 128, 2, 64, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, 128, 1, 64, dtype=torch.bfloat16, requires_grad=True)
    FO.flash_attention(q, k, k).float().sum().backward()
    assert q.grad.dtype == torch.bfloat16 and k.grad.dtype == torch.bfloat16
    assert torch.isfinite(q.grad.float()).all()


@pytest.mark.parametrize("bad", ["device", "dtype", "heads", "shape", "o",
                                 "do", "lse_dtype", "lse_shape"])
def test_flash_bwd_rejects_what_the_kernels_do_not_take(bad):
    q, o, do = (torch.zeros(4, 128, 64) for _ in range(3))
    k = torch.zeros(2, 128, 64)
    lse = torch.zeros(4, 128)
    exc = ValueError
    if bad == "device":         # neither cpu nor cuda
        q, k, o, do, lse = (x.to("meta") for x in (q, k, o, do, lse))
    elif bad == "dtype":
        q, k, o, do = (x.half() for x in (q, k, o, do))
        exc = TypeError
    elif bad == "heads":        # 4 query rows over 3 KV rows
        k = torch.zeros(3, 128, 64)
    elif bad == "shape":        # S not a multiple of 128
        q, o, do, k = (torch.zeros(x.shape[0], 200, 64)
                       for x in (q, o, do, k))
        lse = torch.zeros(4, 200)
    elif bad == "o":
        o = torch.zeros(4, 256, 64)
    elif bad == "do":
        do = do.double()
    elif bad == "lse_dtype":
        lse = lse.bfloat16()
    else:
        lse = torch.zeros(4, 128, 1)
    with pytest.raises(exc):
        FK.flash_bwd(q, k, k, o, lse, do)


def _seen_tiles(kind, index, S, window, causal):
    """Brute force: the first and last tile of the other side that holds a
    visible (query, key) pair with block ``index``."""
    rows, keys = FK.DQ_TILE if kind == "dq" else FK.DKV_TILE
    q = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    vis = np.ones((S, S), bool)
    if causal:
        vis &= k <= q
    if window:
        vis &= k > q - window
    if kind == "dq":
        seen = np.flatnonzero(vis[index * rows:(index + 1) * rows].any(0))
        return seen.min() // keys, seen.max() // keys
    seen = np.flatnonzero(vis[:, index * keys:(index + 1) * keys].any(1))
    return seen.min() // rows, seen.max() // rows


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("window,causal", [(0, True), (64, True),
                                           (128, True), (1024, True),
                                           (0, False), (200, False)])
def test_visible_tiles_match_the_mask(kind, window, causal):
    """The tile ranges the bf16 backward kernels walk, mirrored by
    ``visible_tiles``, are exactly the tiles that hold a visible pair."""
    S = 1024
    block = FK.DQ_TILE[0] if kind == "dq" else FK.DKV_TILE[1]
    for index in range(S // block):
        assert FK.visible_tiles(kind, index, S, window, causal) == \
            _seen_tiles(kind, index, S, window, causal), index


def test_visible_tiles_rejects_an_unknown_kind():
    with pytest.raises(ValueError):
        FK.visible_tiles("dk", 0, 256)


def test_tiles_match_the_cuda_source():
    """DQ_TILE and DKV_TILE are the constants csrc/flash_bwd.cu uses."""
    import re
    src = (FK.CSRC / "flash_bwd.cu").read_text()
    const = {name: int(v) for name, v in re.findall(
        r"constexpr int (DQ_ROWS|DQ_KEYS|DKV_KEYS|DKV_ROWS) = (\d+);", src)}
    assert FK.DQ_TILE == (const["DQ_ROWS"], const["DQ_KEYS"])
    assert FK.DKV_TILE == (const["DKV_ROWS"], const["DKV_KEYS"])
    # whole query blocks and key blocks for every S the wrapper takes
    assert FK.BLOCK % FK.DQ_TILE[0] == 0 and FK.BLOCK % FK.DKV_TILE[1] == 0


def test_row_stats_align_lse_and_sum_delta():
    """lse comes back [B, Hq, S] on a 16-byte boundary (the dk/dv kernel
    bulk-copies its rows) with the same values; delta is rowsum(do * o) in
    float32."""
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.standard_normal((2, 4, 128, 64), np.float32))
    do = torch.from_numpy(rng.standard_normal((2, 4, 128, 64), np.float32))
    flat = torch.from_numpy(rng.standard_normal(2 * 4 * 128 + 1,
                                                np.float32))
    lse = flat[1:].view(2, 4, 128)              # 4 bytes past the storage
    assert lse.data_ptr() % 16
    got_lse, delta = FK._row_stats(lse, o.bfloat16(), do.bfloat16())
    assert got_lse.data_ptr() % 16 == 0 and got_lse.is_contiguous()
    assert torch.equal(got_lse, lse)
    want = (do.bfloat16().float() * o.bfloat16().float()).sum(-1)
    assert delta.dtype == torch.float32 and delta.shape == (2, 4, 128)
    torch.testing.assert_close(delta, want, atol=1e-5, rtol=1e-5)
    aligned = lse.clone()
    assert FK._row_stats(aligned, o, do)[0].data_ptr() == aligned.data_ptr()
