"""The port's flash attention forward against the JAX package.

On CPU tensors every entry point runs the CUDA kernel's plain version
(``kernels/flash_attention/ref.py``).  Each is held against the reference's
``flash_fwd`` (the Pallas kernel in interpret mode) on the reference's
``FLASH_CASES`` (``tests/test_kernels.py:19-26``) and on danube-like cases
(head dim 120, GQA group 4, windows 64 and 128, S 256 and 384), on
minicpm3-like (head dim 96, MHA) and qwen2-vl-like cases (head dim 128,
GQA group 6), at the
reference's tolerances: ``o`` atol = rtol = 2e-5 in float32 and 2e-2 in
bf16, ``lse`` 1e-5 in float32 and 1e-2 in bf16.  The kernel itself is held
against the plain version on the card by ``chip_smoke.py`` (*flash*).

Here the bf16 kernel's plan is checked on the CPU: its tile constants
against ``csrc/flash_fwd.cu``, the key tiles each 128-row block walks and
which of them each consumer warpgroup's 64 rows mask (``visible_tiles``,
``tile_kind``) against the dense mask, and a torch model of the kernel's
arithmetic (128-key tiles in order, base-2 online softmax with the finite
mask value, the mask only on tiles that are not wholly visible, p rounded
to bf16 in bf16 cases, lse back to the natural log) against
``attention_ref`` and the reference on the same cases.
"""
import functools
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_fwd as r_flash_fwd  # noqa: E402,E501

from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402

# (BH, query rows per KV row, S, D, window, dtype)
CASES = [
    # the reference's FLASH_CASES
    (4, 2, 256, 64, 0, "float32"),
    (2, 1, 512, 128, 0, "float32"),
    (4, 4, 256, 64, 128, "float32"),
    (2, 2, 384, 64, 0, "bfloat16"),
    (8, 1, 256, 64, 64, "bfloat16"),
    # danube-like: head dim 120, GQA group 4, windows that bite
    (8, 4, 256, 120, 64, "float32"),
    (8, 4, 384, 120, 128, "float32"),
    (8, 4, 256, 120, 128, "bfloat16"),
    (8, 4, 384, 120, 64, "bfloat16"),
    # minicpm3's MLA: head dim 96 (V padded to it), one KV row a query row
    (4, 1, 256, 96, 0, "float32"),
    (4, 1, 384, 96, 0, "bfloat16"),
    # qwen2-vl: head dim 128, GQA group 6
    (12, 6, 256, 128, 0, "float32"),
    (12, 6, 256, 128, 0, "bfloat16"),
]
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}     # (o, lse)
ENTRIES = ("attention_ref", "flash_fwd", "flash_fwd_view", "flash_attention")


def _inputs(case):
    BH, g, S, D, _, _ = case
    rng = np.random.default_rng(0)
    return (rng.standard_normal((BH, S, D), np.float32),
            rng.standard_normal((BH // g, S, D), np.float32),
            rng.standard_normal((BH // g, S, D), np.float32))


@functools.lru_cache(maxsize=None)
def _reference(case):
    _, _, _, D, window, dtype = case
    q, k, v = (jnp.asarray(x, getattr(jnp, dtype)) for x in _inputs(case))
    o, lse = r_flash_fwd(q, k, v, scale=1.0 / np.sqrt(D), window=window)
    return np.asarray(o, np.float32), np.asarray(lse)


def _port(case, entry):
    """(o [BH, S, D], lse [BH, S] or None) of one port entry point."""
    BH, g, S, D, window, dtype = case
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype))
               for x in _inputs(case))
    if entry == "attention_ref":
        return FR.attention_ref(q, k, v, window=window)
    if entry == "flash_fwd":
        return FK.flash_fwd(q, k, v, window=window)
    # [B, S, H, D] activations with B = 2 where the KV rows split evenly
    B = 2 if (BH // g) % 2 == 0 else 1
    act = [x.reshape(B, -1, S, D).transpose(1, 2).contiguous()
           for x in (q, k, v)]
    if entry == "flash_fwd_view":
        o, lse = FK.flash_fwd(*(x.transpose(1, 2) for x in act),
                              window=window)
        return o.reshape(BH, S, D), lse.reshape(BH, S)
    o = FO.flash_attention(*act, window=window)
    return o.transpose(1, 2).reshape(BH, S, D), None


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_port_matches_reference_flash_fwd(case, entry):
    o_ref, lse_ref = _reference(case)
    o, lse = _port(case, entry)
    tol_o, tol_l = TOL[case[-1]]
    assert o.dtype == getattr(torch, case[-1])
    np.testing.assert_allclose(o.float().numpy(), o_ref, atol=tol_o,
                               rtol=tol_o)
    if lse is not None:
        assert lse.dtype == torch.float32
        np.testing.assert_allclose(lse.numpy(), lse_ref, atol=tol_l,
                                   rtol=tol_l)


def test_first_tile_fully_masked_rows():
    """Rows whose first visited keys are all masked (window smaller than a
    block) still match the reference: its correction factor wipes them."""
    case = (2, 1, 256, 64, 3, "float32")
    o_ref, lse_ref = _reference(case)
    o, lse = _port(case, "flash_fwd")
    np.testing.assert_allclose(o.numpy(), o_ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("entry", ["flash_fwd", "flash_attention"])
def test_sequence_not_multiple_of_128_raises(entry):
    # the reference leaves rows 128-199 unwritten (NaN) at S = 200
    x = torch.zeros(1, 200, 2, 64)
    with pytest.raises(ValueError, match="multiple of 128"):
        if entry == "flash_fwd":
            FK.flash_fwd(x[0].transpose(0, 1), x[0].transpose(0, 1),
                         x[0].transpose(0, 1))
        else:
            FO.flash_attention(x, x, x)


@pytest.mark.parametrize("bad", ["device", "dtype", "heads", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(4, 128, 64)
    k = torch.zeros(2, 128, 64)
    if bad == "device":         # neither cpu nor cuda
        q, k = q.to("meta"), k.to("meta")
        exc = ValueError
    elif bad == "dtype":
        q, k = q.half(), k.half()
        exc = TypeError
    elif bad == "heads":        # 4 query rows over 3 KV rows
        k = torch.zeros(3, 128, 64)
        exc = ValueError
    else:
        k = torch.zeros(2, 256, 64)
        exc = ValueError
    with pytest.raises(exc):
        FK.flash_fwd(q, k, k)


def test_fwd_tile_matches_the_cuda_source():
    """FWD_TILE is (FWD_ROWS, FWD_KEYS) of csrc/flash_fwd.cu, whole blocks
    for every S the wrapper takes."""
    src = (FK.CSRC / "flash_fwd.cu").read_text()
    const = {name: int(v) for name, v in re.findall(
        r"constexpr int (FWD_ROWS|FWD_KEYS) = (\d+);", src)}
    assert FK.FWD_TILE == (const["FWD_ROWS"], const["FWD_KEYS"])
    assert FK.BLOCK % FK.FWD_TILE[0] == 0


def _visible(S, window, causal):
    q = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    vis = np.ones((S, S), bool)
    if causal:
        vis &= k <= q
    if window:
        vis &= k > q - window
    return vis


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 64, 128, 1000, 8192])
def test_fwd_tile_plan_matches_the_mask(window, causal):
    """Each forward block's key tiles (``visible_tiles("fwd", ...)``) hold
    every visible pair of its rows, and every tile outside them is wholly
    masked; within them, a tile that a consumer's 64 rows take unmasked
    (``tile_kind`` "all") is wholly visible to those rows, "none" wholly
    masked, "some" partly: only those two run the element mask."""
    S = 1024
    rows, keys = FK.FWD_TILE
    vis = _visible(S, window, causal)
    masked = 0
    for index in range(S // rows):
        first, last = FK.visible_tiles("fwd", index, S, window, causal)
        block = vis[index * rows:(index + 1) * rows]
        seen = np.flatnonzero(block.any(0)) // keys
        assert (first, last) == (seen.min(), seen.max()), index
        for j in range(first, last + 1):
            for half in range(2):
                qa = index * rows + half * rows // 2
                tile = vis[qa:qa + rows // 2, j * keys:(j + 1) * keys]
                kind = FK.tile_kind(qa, qa + rows // 2 - 1, j * keys,
                                    (j + 1) * keys - 1, window, causal)
                want = ("all" if tile.all() else
                        "none" if not tile.any() else "some")
                assert kind == want, (index, j, half)
                masked += kind != "all"
    if causal or 0 < window < S:      # a mask bites somewhere
        assert masked > 0


LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _kernel_model(q, k, v, *, window=0, causal=True):
    """The bf16 forward kernel's arithmetic in torch float32: per 128-row
    block and 64-row consumer, the block's 128-key tiles in order; scores
    s = q k^T; on tiles the consumer does not see whole, masked scores are
    NEG_INF in the row maximum and give p = 0; m (base 2) = max(m, max(s)
    * scale * log2(e)), p = 2^(s * scale * log2(e) - m), the output and l
    rescaled by 2^(m_old - m); p rounded to bf16 for o += p v when the
    inputs are bf16; lse = m ln(2) + log(l) at the end."""
    BH, S, D = q.shape
    group = BH // k.shape[0]
    kr = k.float().repeat_interleave(group, 0)
    vr = v.float().repeat_interleave(group, 0)
    sl2 = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32) * LOG2E
    rows, keys = FK.FWD_TILE
    half = rows // 2
    o = torch.empty(BH, S, D)
    lse = torch.empty(BH, S)
    for index in range(S // rows):
        first, last = FK.visible_tiles("fwd", index, S, window, causal)
        for qa in (index * rows, index * rows + half):
            qs = q[:, qa:qa + half].float()
            qp = torch.arange(qa, qa + half)[:, None]
            m = torch.full((BH, half), FR.NEG_INF)
            l = torch.zeros(BH, half)
            acc = torch.zeros(BH, half, D)
            for j in range(first, last + 1):
                k0 = j * keys
                s = qs @ kr[:, k0:k0 + keys].transpose(1, 2)
                kind = FK.tile_kind(qa, qa + half - 1, k0, k0 + keys - 1,
                                    window, causal)
                if kind != "all":
                    kp = torch.arange(k0, k0 + keys)[None, :]
                    ok = torch.ones(half, keys, dtype=torch.bool)
                    if causal:
                        ok &= kp <= qp
                    if window:
                        ok &= kp > qp - window
                    s = torch.where(ok, s, torch.tensor(FR.NEG_INF))
                mn = torch.maximum(m, s.amax(-1) * sl2)
                c = torch.exp2(m - mn)
                p = torch.exp2(s * sl2 - mn[..., None])
                if kind != "all":
                    p = torch.where(ok, p, torch.zeros(()))
                l = l * c + p.sum(-1)
                if q.dtype == torch.bfloat16:
                    p = p.bfloat16().float()
                acc = acc * c[..., None] + p @ vr[:, k0:k0 + keys]
                m = mn
            l = l.clamp_min(1e-30)
            o[:, qa:qa + half] = acc / l[..., None]
            lse[:, qa:qa + half] = m * LN2 + torch.log(l)
    return o.to(q.dtype), lse


def _first_tile_wholly_masked_rows(case):
    """Rows whose first visited key tile holds none of their keys."""
    _, _, S, _, window, _ = case
    rows, keys = FK.FWD_TILE
    vis = _visible(S, window, True)
    n = 0
    for index in range(S // rows):
        first, _ = FK.visible_tiles("fwd", index, S, window)
        tile = vis[index * rows:(index + 1) * rows,
                   first * keys:(first + 1) * keys]
        n += int((~tile.any(1)).sum())
    return n


@pytest.mark.parametrize("against", ["attention_ref", "reference"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_model_matches(case, against):
    """The model of the bf16 kernel's arithmetic equals the plain version
    and the reference's flash_fwd (interpret mode) at the module's
    tolerances; the window-64 cases include rows whose first visited tile
    is wholly masked for them."""
    BH, g, S, D, window, dtype = case
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype))
               for x in _inputs(case))
    o, lse = _kernel_model(q, k, v, window=window)
    if against == "attention_ref":
        o_ref, lse_ref = (x.float().numpy() for x in
                          FR.attention_ref(q, k, v, window=window))
    else:
        o_ref, lse_ref = _reference(case)
    if window == 64:
        assert _first_tile_wholly_masked_rows(case) > 0
    tol_o, tol_l = TOL[dtype]
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), o_ref, atol=tol_o,
                               rtol=tol_o)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=tol_l, rtol=tol_l)
