"""Plain torch versions of the Mamba-2 SSD (state-space duality) scan.

:func:`ssd_chunked_ref` is the plain version of the CUDA kernel
(``csrc/ssd.cu``): the reference's kernel body
(``src/repro/kernels/ssd/kernel.py:32-57``) on ``[B*H, S, P]`` inputs,
chunk by chunk in float32, batched over the rows.  :func:`segsum_exp` and
:func:`ssd_reference` are the port of the model-side oracle
(``src/repro/models/ssm.py:71-124``) in the model's ``[B, S, H, P]``
layout; the SSM mixer's plain path runs the latter.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["ssd_chunked_ref", "segsum_exp", "ssd_reference"]


def _tril(Q: int, device) -> torch.Tensor:
    return torch.ones((Q, Q), dtype=torch.bool, device=device).tril()


def ssd_chunked_ref(x, a, Bm, Cm, *, chunk: int, n_heads: int):
    """x: [BH, S, P]; a: [BH, S]; Bm/Cm: [B, S, N], row ``bh // n_heads``
    shared by the heads of a batch row.  ``S`` a multiple of ``chunk``.
    Returns (y [BH, S, P], final state [BH, N, P]), both float32.

    Per chunk of Q rows, with the state carried in order:
    ``cum = cumsum(a)``, ``L = tril(exp(cum_i - cum_j))``,
    ``y = ((C B^T) * L) x + (C * exp(cum)) state``,
    ``state = state * exp(cum[-1]) + (B * exp(cum[-1] - cum))^T x``.
    """
    BH, S, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"ssd_chunked_ref: S={S} is not a multiple of the "
                         f"chunk {Q}")
    rows = torch.arange(BH, device=x.device) // n_heads
    tri = _tril(Q, x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    state = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    y = torch.empty((BH, S, P), dtype=torch.float32, device=x.device)
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xk = x[:, sl].float()                            # [BH, Q, P]
        cum = a[:, sl].float().cumsum(-1)                # [BH, Q]
        Bb, Cb = Bm[:, sl].float(), Cm[:, sl].float()    # [B, Q, N]
        L = torch.where(tri, torch.exp(cum[:, :, None] - cum[:, None, :]),
                        zero)
        G = (Cb @ Bb.transpose(1, 2))[rows]              # [BH, Q, Q]
        Bk, Ck = Bb[rows], Cb[rows]                      # [BH, Q, N]
        y[:, sl] = (G * L) @ xk + (Ck * torch.exp(cum)[..., None]) @ state
        decay_to_end = torch.exp(cum[:, -1:] - cum)      # [BH, Q]
        state = state * torch.exp(cum[:, -1])[:, None, None] + \
            (Bk * decay_to_end[..., None]).transpose(1, 2) @ xk
    return y, state


def segsum_exp(a: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(sum_{j<k<=i} a_k) for i >= j, else 0.  a: [..., Q].

    The values are the reference's ``where(tril, exp(diff), 0)``, bit for
    bit, but the mask is taken before the exponential: above the diagonal
    ``diff`` is a sum of ``-a > 0``, which overflows float32 at mamba2's
    full width (174 in a chunk of 128), and the reference's gradient there
    is ``0 * exp(diff) = 0 * inf``, NaN in every leaf before the scan."""
    Q = a.shape[-1]
    cum = a.cumsum(-1)
    diff = cum[..., :, None] - cum[..., None, :]        # [..., i, j]
    return torch.exp(diff.masked_fill(~_tril(Q, a.device), float("-inf")))


def _chunk(state, xk, ak, Bk, Ck):
    """One chunk of :func:`ssd_reference`: (new state, y [B, Q, H, P])."""
    xk = xk.float()
    cum = ak.cumsum(1)                                   # [B, Q, H]
    L = segsum_exp(ak.transpose(1, 2))                   # [B, H, Q, Q]
    G = torch.einsum("bqn,bkn->bqk", Ck, Bk)             # [B, Q, Q]
    y = torch.einsum("bhqk,bkhp->bqhp", G[:, None] * L, xk)
    y = y + torch.einsum("bqn,bhpn,bqh->bqhp", Ck, state, torch.exp(cum))
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)       # [B, Q, H]
    new_state = state * torch.exp(cum[:, -1, :])[..., None, None] + \
        torch.einsum("bqn,bqh,bqhp->bhpn", Bk, decay_to_end, xk)
    return new_state, y


def ssd_reference(x, a, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan, sequential over chunks like the kernel.

    x: [B, S, H, P] inputs (already dt-scaled); a: [B, S, H] log decay per
    step (negative); Bm, Cm: [B, S, N] (one group, shared by the heads).
    Returns (y [B, S, H, P], final state [B, H, P, N]), float32.

    Under autograd each chunk is recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` on the
    scan body), so one chunk's ``[Q, Q]`` matrices exist at a time.
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"ssd_reference: S={S} is not a multiple of the "
                         f"chunk {Q}")
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, a, Bm, Cm, state))
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        args = (state, x[:, sl], a[:, sl].float(), Bm[:, sl].float(),
                Cm[:, sl].float())
        state, y = checkpoint(_chunk, *args, use_reentrant=False) if remat \
            else _chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), state
