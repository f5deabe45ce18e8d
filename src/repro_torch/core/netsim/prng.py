"""threefry2x32 counter-based PRNG, bit-compatible with ``jax.random``.

Reproduces ``jax.random.PRNGKey``, ``split`` and ``uniform`` (float32) in
jax's legacy, non-partitionable mode (``jax_threefry_partitionable=False``),
the mode the simulator's golden constants were captured in.  The engine's
only randomness is the DCQCN coin flip, so matching these bits is what lets
the port reproduce the reference's finish ticks exactly.

torch's uint32 support is partial, so words are held as int64 tensors with
values in ``[0, 2**32)`` and every add is masked with ``& 0xFFFFFFFF``.
A key is an int64 tensor whose last axis has length 2; leading axes are
lanes (one independent key per simulation lane).  Runs on any device;
``split`` and ``uniform`` stay on their key's.
"""
from __future__ import annotations

import torch

from ...device import resolve_device

__all__ = ["prng_key", "split", "uniform", "threefry2x32"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block function on broadcastable words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``threefry_2x32(key, iota(n))``: n words per key, ``[..., n]``."""
    m = n + (n % 2)
    half = m // 2
    cnt = torch.arange(m, dtype=torch.int64, device=key.device)
    if n % 2:
        cnt[-1] = 0                      # jax pads odd counts with one zero
    k0 = key[..., 0:1]
    k1 = key[..., 1:2]
    y0, y1 = threefry2x32(k0, k1, cnt[:half], cnt[half:])
    return torch.cat([y0, y1], dim=-1)[..., :n]


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[hi32(seed), lo32(seed)]``; a list of
    seeds gives one key per lane, ``[S, 2]``.  ``device=None`` is the CUDA
    card (raises without one)."""
    s = torch.as_tensor(seed, dtype=torch.int64,
                        device=resolve_device(device))
    return torch.stack([(s >> 32) & _M32, s & _M32], dim=-1)


def split(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.split(key)`` into ``(new_key, subkey)``."""
    b = _bits(key, 4)
    return b[..., 0:2], b[..., 2:4]


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32: ``[..., *shape]``."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    bits = _bits(key, n)
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = fb.view(torch.float32) - 1.0
    f = torch.clamp(f, min=0.0)
    return f.reshape(key.shape[:-1] + shape)
