"""The port's flash attention forward against the JAX package.

On CPU tensors every entry point runs the CUDA kernel's plain version
(``kernels/flash_attention/ref.py``).  Each is held against the reference's
``flash_fwd`` (the Pallas kernel in interpret mode) on the reference's
``FLASH_CASES`` (``tests/test_kernels.py:19-26``) and on danube-like cases
(head dim 120, GQA group 4, windows 64 and 128, S 256 and 384), at the
reference's tolerances: ``o`` atol = rtol = 2e-5 in float32 and 2e-2 in
bf16, ``lse`` 1e-5 in float32 and 1e-2 in bf16.  The kernel itself is held
against the plain version on the card by ``chip_smoke.py`` (*flash*).
"""
import functools

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
