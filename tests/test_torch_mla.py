"""The port's MLA (``models/mla.py``) against the JAX package, on
minicpm3's SMOKE config (2 layers, 4 heads, ranks 64/32, qk 32 + 16, v 32).

The reference's parameters (``model.init(PRNGKey(0))``) are carried into
the port by ``params_from_reference``.  ``mla_block`` (plain and flash,
S 128: V padded 32 -> 48 for the attention), ``mla_decode`` step by step
(the absorbed form over the bf16 latent and rope-key caches),
``LM.apply`` and ``decode_step`` are compared with the reference's:

- in float32 (weights cast on both sides) at rtol 1e-4, atol 1e-3 for the
  logits (up to ~145 here) and 1e-5 / 1e-4 for one block;
- in bf16 at the reference's model tolerance, atol 0.15, rtol 0.1
  (``tests/test_models.py:108-110``);
- decode reads bf16 caches on both sides, so float32 decode logits are
  held to atol 1e-2, rtol 1e-4, as the GQA decode is;
- decode against the port's own prefill at the reference's MLA tolerance,
  atol 0.2, rtol 0.1 (``tests/test_models.py:134-150``).

The JAX side runs its flash kernel in interpret mode.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.models import mla as r_mla  # noqa: E402
from repro.models.params import cast_tree as r_cast_tree  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import (build_model, params_from_reference,  # noqa: E402,E501
                                params_to_reference)
from repro_torch.models import mla as P_mla  # noqa: E402
from repro_torch.models.params import cast_tree  # noqa: E402

ARCH = "minicpm3_4b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
       "bfloat16": dict(rtol=0.1, atol=0.15)}
DECODE_TOL = {"float32": dict(rtol=1e-4, atol=1e-2),
              "bfloat16": TOL["bfloat16"]}
MLA_DECODE_TOL = dict(atol=0.2, rtol=0.1)
B, S = 2, 128           # a multiple of flash's 128 rows


def _np(x):
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's SMOKE parameters and their float32 numpy tree."""
    with jax.threefry_partitionable(False):
        params = r_build_model(r_registry.get_config(ARCH, smoke=True)).init(
            jax.random.PRNGKey(0))
    return params, jax.tree.map(_np, params)


def _configs(dtype):
    return (dataclasses.replace(r_registry.get_config(ARCH, smoke=True),
                                dtype=dtype),
            dataclasses.replace(registry.get_config(ARCH, smoke=True),
                                dtype=dtype))


def _models(dtype, use_flash=False):
    """(reference model, its params, port model) in ``dtype``."""
    params, tree = _reference()
    rc, pc = _configs(dtype)
    port = params_from_reference(pc, tree, "cpu", use_flash=use_flash)
    if dtype == "float32":
        params = r_cast_tree(params, jnp.float32)
        cast_tree(port, torch.float32)
    return r_build_model(rc, use_flash=use_flash), params, port


def _tokens(n=S, seed=0):
    return np.random.default_rng(seed).integers(
        0, registry.get_config(ARCH, smoke=True).vocab_size,
        (B, n)).astype(np.int32)


def _layer0():
    """Layer 0's MLA leaves, float32: numpy for the reference, tensors for
    the port."""
    leaves = {k: v[0].copy()
              for k, v in _reference()[1]["block_0"]["attn"].items()}
    return ({k: jnp.asarray(v) for k, v in leaves.items()},
            {k: torch.from_numpy(v) for k, v in leaves.items()})


@pytest.mark.parametrize("use_flash", [False, True])
def test_mla_block(use_flash):
    rc, pc = _configs("float32")
    rp, pp = _layer0()
    x = np.random.default_rng(1).standard_normal(
        (B, S, rc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = r_mla.mla_block(rp, jnp.asarray(x), rc, jnp.asarray(pos),
                           use_flash=use_flash)
    got = P_mla.mla_block(pp, torch.from_numpy(x), pc, torch.from_numpy(pos),
                          use_flash=use_flash)
    assert got.shape == (B, S, rc.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-4)


def test_mla_decode_step_by_step():
    """12 absorbed decode steps of layer 0 on random inputs: outputs at the
    float32 block tolerance, the bf16 latent and rope-key caches (written
    in place on the port's side) at one bf16 ulp."""
    rc, pc = _configs("float32")
    rp, pp = _layer0()
    m = rc.mla
    rng = np.random.default_rng(2)
    rcache = r_mla.MLACache(
        c=jnp.zeros((B, 16, m.kv_lora_rank), jnp.bfloat16),
        k_rope=jnp.zeros((B, 16, m.qk_rope_head_dim), jnp.bfloat16))
    pcache = P_mla.init_mla_cache(pc, B, 16, "cpu")
    for t in range(12):
        x = rng.standard_normal((B, 1, rc.d_model)).astype(np.float32)
        pos = np.array([t, max(t - 3, 0)], np.int32)
        want, rcache = r_mla.mla_decode(rp, jnp.asarray(x), rc, rcache,
                                        jnp.asarray(pos))
        got, same = P_mla.mla_decode(pp, torch.from_numpy(x), pc, pcache,
                                     torch.from_numpy(pos))
        assert same is pcache
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {t}")
    for mine, theirs in ((pcache.c, rcache.c),
                         (pcache.k_rope, rcache.k_rope)):
        assert mine.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(mine.float()), _np(theirs),
                                   atol=1e-6, rtol=2 ** -7)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_apply(dtype, use_flash):
    rmodel, params, port = _models(dtype, use_flash)
    toks = _tokens()
    want, _ = rmodel.apply(params, jnp.asarray(toks))
    with torch.inference_mode():
        got, aux = port.apply(torch.from_numpy(toks))
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got.float()), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step(dtype):
    rmodel, params, port = _models(dtype)
    toks = _tokens(12, seed=3)
    rcache = rmodel.init_cache(B, 16)
    pcache = port.init_cache(B, 16)
    assert all(isinstance(c, P_mla.MLACache) for c in pcache)
    step = jax.jit(rmodel.decode_step)
    for t in range(toks.shape[1]):
        want, rcache = step(params, rcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.full((B,), t, jnp.int32))
        with torch.inference_mode():
            got, pcache = port.decode_step(
                pcache, torch.from_numpy(toks[:, t:t + 1]),
                torch.full((B,), t, dtype=torch.int32))
        np.testing.assert_allclose(_np(got.float()), _np(want),
                                   err_msg=f"token {t}", **DECODE_TOL[dtype])


def test_decode_matches_prefill():
    """Absorbed decode == the materialized prefill, token by token (the
    port of the reference's ``test_mla_decode_matches_prefill``)."""
    model = build_model(registry.get_config(ARCH, smoke=True), device="cpu")
    T = 12
    toks = torch.from_numpy(_tokens(T, seed=4))
    with torch.inference_mode():
        full, _ = model.apply(toks)
        cache = model.init_cache(B, 16)
        outs = []
        for t in range(T):
            lg, cache = model.decode_step(cache, toks[:, t:t + 1],
                                          torch.full((B,), t))
            outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1).float()),
                               _np(full.float()), **MLA_DECODE_TOL)


def test_params_round_trip_and_layout():
    """MLA leaves under ``attn`` (latent norms float32), layer l at
    ``block_0[l]``; the reference's tree comes back exactly; the KV cache
    holds ``max_seq`` positions (no window) for ServeEngine's check."""
    _, tree = _reference()
    cfg = registry.get_config(ARCH, smoke=True)
    model = params_from_reference(cfg, tree, "cpu")
    attn = model.blocks[0].attn
    assert set(attn) == set(tree["block_0"]["attn"])
    assert attn["q_norm"].dtype == attn["kv_norm"].dtype == torch.float32
    assert attn["wq_b"].dtype == torch.bfloat16
    back = params_to_reference(model)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(jax.tree.leaves(back))
    for path, want in leaves:
        have = back
        for k in path:
            have = have[k.key]
        np.testing.assert_array_equal(have, want,
                                      err_msg=jax.tree_util.keystr(path))
    assert model.kv_cache_len(64) == 64
