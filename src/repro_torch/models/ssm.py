"""Mamba-2 SSD blocks.

The port of ``repro/models/ssm.py``.  Prefill runs the chunked SSD scan,
through the CUDA kernel (``use_kernel``, :func:`repro_torch.kernels.ssd.ssd`)
or through the plain chunk walk (:func:`~repro_torch.kernels.ssd.ref.
ssd_reference`); decode is the O(1)-per-token recurrence with a conv window
state.  The reference's dtype flow is kept: the depthwise conv runs in the
input dtype and its SiLU in float32; dt, A, the log decay and the scan
inputs are float32; the gated RMSNorm is float32, cast back before the
output projection.  Under ``flags.ROOFLINE_MODE`` the plain path runs
:func:`ssd_reference_vec`, the scan vectorized over chunks (the dry-run's
loop-free route; ``flags.SSD_BF16`` keeps its O(Q^2) tensors in bf16).

Shapes: x_in [B, S, d_model]; heads H = d_inner / head_dim (padded to a
multiple of the tensor-parallel width by :func:`ssm_dims`); state N =
cfg.ssm.d_state.

A tensor-parallel rank (``models/lm.py``) runs :func:`ssm_block` as it
stands on its blocks of the heads (``wz``, ``wx``, ``wdt``, ``dt_bias``,
``A_log``, ``D``, ``conv_x``, ``norm``, ``wo``) with ``wB``, ``wC`` and
``conv_BC`` whole: the depthwise conv, the scan, the skip and the gated
RMSNorm (its mean over ``head_dim``) are per channel or per head, so the
rank's output is its share of the ``wo`` product, summed over ``model``
by the caller.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import flags
from ..config import ModelConfig
from ..kernels.ssd.ops import ssd
from ..kernels.ssd.ref import segsum_exp, ssd_reference
from ..parallel.sharding import padded
from .params import ParamSpec

__all__ = ["ssm_dims", "ssm_spec", "SSMCache", "ssm_block", "ssm_decode",
           "init_ssm_cache", "ssd_reference_vec"]


def ssm_dims(cfg: ModelConfig, tp: int) -> tuple[int, int]:
    """(padded heads, d_inner padded)."""
    s = cfg.ssm
    h = padded(s.expand * cfg.d_model // s.head_dim, tp)
    return h, h * s.head_dim


def ssm_spec(cfg: ModelConfig, tp: int, layers: int | None = None) -> dict:
    """One layer's mixer; ``layers`` is the reference's stacked axis."""
    s, d = cfg.ssm, cfg.d_model
    H, _ = ssm_dims(cfg, tp)
    hd, N, st = s.head_dim, s.d_state, layers or 1
    f32 = torch.float32
    return {
        "wz": ParamSpec((d, H, hd), ("embed", "ssm_heads", "head_dim"),
                        stack=st),
        "wx": ParamSpec((d, H, hd), ("embed", "ssm_heads", "head_dim"),
                        stack=st),
        "wB": ParamSpec((d, N), ("embed", "state"), stack=st),
        "wC": ParamSpec((d, N), ("embed", "state"), stack=st),
        "wdt": ParamSpec((d, H), ("embed", "ssm_heads"), stack=st),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="zeros", dtype=f32,
                             stack=st),
        "A_log": ParamSpec((H,), ("ssm_heads",), init="constant", scale=0.5,
                           dtype=f32, stack=st),
        "D": ParamSpec((H,), ("ssm_heads",), init="ones", dtype=f32,
                       stack=st),
        "conv_x": ParamSpec((s.d_conv, H, hd),
                            ("conv", "ssm_heads", "head_dim"), init="normal",
                            scale=0.3, stack=st),
        "conv_BC": ParamSpec((s.d_conv, 2 * N), ("conv", "state"),
                             init="normal", scale=0.3, stack=st),
        "norm": ParamSpec((H, hd), ("ssm_heads", "head_dim"), init="ones",
                          dtype=f32, stack=st),
        "wo": ParamSpec((H, hd, d), ("ssm_heads", "head_dim", "embed"),
                        stack=st),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq. u: [B, S, C]; w: [K, C]."""
    K, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    return sum(pad[:, i: i + S] * w[i] for i in range(K))


class SSMCache(NamedTuple):
    conv: torch.Tensor    # [B, K-1, H*hd + 2N] last conv inputs
    state: torch.Tensor   # [B, H, hd, N] float32


def _proj_inputs(p, x_in: torch.Tensor):
    def heads(w):
        return (x_in @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
    return (heads(p["wz"]), heads(p["wx"]), x_in @ p["wB"], x_in @ p["wC"],
            x_in @ p["wdt"])


def _conv_weight(p, cfg: ModelConfig, H: int, hd: int) -> torch.Tensor:
    return torch.cat([p["conv_x"].reshape(cfg.ssm.d_conv, H * hd),
                      p["conv_BC"]], dim=-1)


def _gated_out(p, y, xh, z, x_in) -> torch.Tensor:
    """The skip term, the gated RMSNorm (float32) and the output
    projection.  y, xh: [..., H, hd] float32; z: [..., H, hd]."""
    y = y + xh.float() * p["D"][:, None]
    y = y * F.silu(z.float())
    var = (y ** 2).mean(-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-6) * p["norm"]).to(x_in.dtype)
    wo = p["wo"]
    return y.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _wide(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dt``, then float32: a product of such values
    accumulates in float32 (``preferred_element_type=jnp.float32``)."""
    return x.to(dt).float()


def ssd_reference_vec(x, a, Bm, Cm, chunk: int):
    """The SSD scan vectorized over chunks (the reference's
    ``ssm.py:127-175``): every chunk's diagonal block and chunk state at
    once, then the inter-chunk recurrence unrolled.  Shapes and returns as
    :func:`~repro_torch.kernels.ssd.ref.ssd_reference`.  Memory-heavy: the
    roofline route, not the production one.  ``flags.SSD_BF16`` keeps the
    [Q, Q] decay and score tensors and the products' inputs in bf16; the
    cumulative sums, exponentials and states stay float32."""
    wdt = torch.bfloat16 if flags.SSD_BF16 else torch.float32
    B, S, H, P = x.shape
    N, Q = Bm.shape[-1], chunk
    if S % Q:
        raise ValueError(f"ssd_reference_vec: S={S} is not a multiple of "
                         f"the chunk {Q}")
    nc = S // Q
    xc = x.reshape(B, nc, Q, H, P)
    ac = a.reshape(B, nc, Q, H).float()
    Bc = Bm.reshape(B, nc, Q, N).to(wdt)
    Cc = Cm.reshape(B, nc, Q, N).to(wdt)
    L = segsum_exp(ac.transpose(2, 3)).to(wdt)          # [B, nc, H, Q, Q]
    G = torch.einsum("bcqn,bckn->bcqk", Cc.float(), Bc.float()).to(wdt)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp",
                          _wide(G[:, :, None] * L, wdt), _wide(xc, wdt))
    cum = ac.cumsum(2)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum).to(wdt)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc.float(),
                          decay_to_end.float(), _wide(xc, wdt))
    chunk_decay = torch.exp(cum[:, :, -1, :])           # [B, nc, H]
    cur = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(cur)
        cur = cur * chunk_decay[:, c][..., None, None] + states[:, c]
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc.float(),
                         torch.stack(entering, dim=1), torch.exp(cum))
    return (y_diag + y_off).reshape(B, S, H, P), cur


def ssm_block(p, x_in: torch.Tensor, cfg: ModelConfig,
              use_kernel: bool = False) -> torch.Tensor:
    """Train/prefill SSD mixer. x_in: [B, S, d_model]."""
    s = cfg.ssm
    B, S, _ = x_in.shape
    z, xh, Bm, Cm, dt = _proj_inputs(p, x_in)
    H, hd = xh.shape[2], xh.shape[3]
    N = Bm.shape[-1]
    # causal conv + silu on (x, B, C)
    u = torch.cat([xh.reshape(B, S, H * hd), Bm, Cm], dim=-1)
    u = F.silu(_causal_conv(u, _conv_weight(p, cfg, H, hd)).float()
               ).to(x_in.dtype)
    xh = u[..., : H * hd].reshape(B, S, H, hd)
    Bm, Cm = u[..., H * hd: H * hd + N], u[..., H * hd + N:]

    dtp = F.softplus(dt.float() + p["dt_bias"])
    a = dtp * -torch.exp(p["A_log"])                   # [B, S, H] log decay
    xs = xh.float() * dtp[..., None]
    if use_kernel:
        y, _ = ssd(xs, a, Bm, Cm, chunk=s.chunk_size)
    else:
        pad = (-S) % s.chunk_size
        if pad:
            xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
            a = F.pad(a, (0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, pad))
        scan = ssd_reference_vec if flags.ROOFLINE_MODE else ssd_reference
        y, _ = scan(xs, a, Bm, Cm, chunk=s.chunk_size)
        y = y[:, :S]
    return _gated_out(p, y, xh, z, x_in)


def ssm_decode(p, x_in: torch.Tensor, cfg: ModelConfig, cache: SSMCache
               ) -> tuple[torch.Tensor, SSMCache]:
    """One-token recurrence. x_in: [B, 1, d_model].  Returns the output and
    a new cache (the caller writes it in place)."""
    B = x_in.shape[0]
    z, xh, Bm, Cm, dt = _proj_inputs(p, x_in)
    H, hd = xh.shape[2], xh.shape[3]
    N = Bm.shape[-1]
    u_new = torch.cat([xh.reshape(B, 1, H * hd), Bm, Cm], dim=-1)
    window = torch.cat([cache.conv, u_new], dim=1)          # [B, K, C]
    w = _conv_weight(p, cfg, H, hd)
    u = F.silu(torch.einsum("bkc,kc->bc", window.float(), w.float()))
    xh1 = u[:, : H * hd].reshape(B, H, hd)
    Bm1, Cm1 = u[:, H * hd: H * hd + N], u[:, H * hd + N:]

    dtp = F.softplus(dt[:, 0].float() + p["dt_bias"])       # [B, H]
    decay = torch.exp(dtp * -torch.exp(p["A_log"]))
    xs = xh1 * dtp[..., None]
    new_state = cache.state * decay[..., None, None] + \
        torch.einsum("bhp,bn->bhpn", xs, Bm1)
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm1)
    out = _gated_out(p, y, xh1, z[:, 0], x_in)[:, None]
    return out, SSMCache(conv=window[:, 1:], state=new_state)


def init_ssm_cache(cfg: ModelConfig, batch: int, tp: int,
                   device=None) -> SSMCache:
    """Zero conv window and state.  The conv window is bf16, as the
    reference allocates it, or float32 for a float32 model: the reference
    concatenates each new bf16 window with the step's inputs, which
    promotes it to the model's dtype from the first step on."""
    s = cfg.ssm
    H, d_in = ssm_dims(cfg, tp)
    conv_dtype = torch.promote_types(torch.bfloat16, getattr(torch, cfg.dtype))
    return SSMCache(
        conv=torch.zeros((batch, s.d_conv - 1, d_in + 2 * s.d_state),
                         dtype=conv_dtype, device=device),
        state=torch.zeros((batch, H, s.head_dim, s.d_state),
                          dtype=torch.float32, device=device))
