"""The port's encoder-decoder (``models/encdec.py``) against the JAX
package, on whisper's SMOKE config (2 + 2 layers, d_model 128, 4 heads of
32, layernorm, GELU, 64 encoder positions, 64 decoder positions).

The reference's ``encoder``/``decoder`` stacks are carried into the
port's per-layer blocks by ``params_from_reference``.  ``encode``,
``decode_train`` (plain and flash, S 128: past the 64 learned positions,
which wrap), ``apply``, ``init_cache``'s cross K/V and greedy
``decode_step`` past ``max_position`` are compared with the reference's:
float32 at rtol 1e-4, atol 1e-3 (logits up to ~130 here); the bf16
encoder at the reference's model tolerance, atol 0.15, rtol 0.1; float32
decode (bf16 self-attention caches on both sides) at atol 1e-2, rtol 1e-4.
The bf16 logits are held to a relative L2 distance per row of BF16_ROW_L2
and equal argmaxes: through the encoder's and the decoder's bf16 roundings
the two frameworks' logits part by 0.57 % (rel L2; 4 of 131,072 outside
atol 0.15 rtol 0.1, by up to 0.2 on logits of ~15), less than the
reference's own bf16 run is from its float32 run (0.61 %; both measured on
this config).  Decode against the port's own teacher-forced decoder reads
bf16 caches on one side only, and is held to the model tolerance, as the
reference's decode-against-prefill tests hold theirs.  The JAX side runs
its flash kernel in interpret mode.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.config import param_count as r_param_count  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.models.params import cast_tree as r_cast_tree  # noqa: E402

from repro_torch.config import ParallelConfig, param_count  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import (EncDec, build_model,  # noqa: E402
                                params_from_reference, params_to_reference)
from repro_torch.models.params import cast_tree  # noqa: E402

ARCH = "whisper_large_v3"
TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
       "bfloat16": dict(rtol=0.1, atol=0.15)}
DECODE_TOL = dict(rtol=1e-4, atol=1e-2)
BF16_ROW_L2 = 2e-2
B = 2
S = 128                 # decoder tokens: a multiple of flash's 128 rows


def _np(x):
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _reference():
    with jax.threefry_partitionable(False):
        params = r_build_model(r_registry.get_config(ARCH, smoke=True)).init(
            jax.random.PRNGKey(0))
    return params, jax.tree.map(_np, params)


@functools.lru_cache(maxsize=None)
def _models(dtype, use_flash=False):
    params, tree = _reference()
    rc = dataclasses.replace(r_registry.get_config(ARCH, smoke=True),
                             dtype=dtype)
    pc = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                             dtype=dtype)
    port = params_from_reference(pc, tree, "cpu", use_flash=use_flash)
    if dtype == "float32":
        params = r_cast_tree(params, jnp.float32)
        cast_tree(port, torch.float32)
    return r_build_model(rc, use_flash=use_flash), params, port


def _frames(seed=0):
    cfg = registry.get_config(ARCH, smoke=True)
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _tokens(n=S, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (B, n)).astype(
        np.int32)


def test_layout_count_and_round_trip():
    """One block a layer with the reference's leaves; param_count (the
    reference's) equals the built parameters less the vocabulary pad; the
    reference's tree comes back exactly."""
    _, tree = _reference()
    cfg = registry.get_config(ARCH, smoke=True)
    model = params_from_reference(cfg, tree, "cpu")
    assert isinstance(model, EncDec)
    assert len(model.encoder) == cfg.encoder_layers
    assert len(model.decoder) == cfg.num_layers
    assert set(model.decoder[1]._modules) == set(tree["decoder"])
    assert set(model.encoder[0]._modules) == set(tree["encoder"])
    pad = (model.vocab_padded - cfg.vocab_size) * cfg.d_model
    assert sum(p.numel() for p in model.parameters()) - pad == \
        param_count(cfg) == r_param_count(r_registry.get_config(ARCH,
                                                                smoke=True))
    back = params_to_reference(model)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(jax.tree.leaves(back))
    for path, want in leaves:
        have = back
        for k in path:
            have = have[k.key]
        np.testing.assert_array_equal(have, want,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode(dtype):
    rmodel, params, port = _models(dtype)
    fr = _frames()
    want = rmodel.encode(params, jnp.asarray(fr))
    with torch.inference_mode():
        got = port.encode(torch.from_numpy(fr))
    assert got.dtype == getattr(torch, dtype)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        TOL["bfloat16"]
    np.testing.assert_allclose(_np(got.float()), _np(want), **tol)


@pytest.mark.parametrize("use_flash", [False, True])
def test_decode_train(use_flash):
    """The teacher-forced decoder on the reference's encoder output, S 128
    (the 64 learned positions wrap), plain and flash."""
    rmodel, params, port = _models("float32", use_flash)
    enc = rmodel.encode(params, jnp.asarray(_frames()))
    toks = _tokens()
    want = rmodel.decode_train(params, jnp.asarray(toks), enc)
    with torch.inference_mode():
        got = port.decode_train(torch.from_numpy(toks),
                                torch.from_numpy(np.array(enc)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply(dtype):
    rmodel, params, port = _models(dtype, use_flash=True)
    toks, fr = _tokens(seed=2), _frames(seed=3)
    want, raux = rmodel.apply(params, jnp.asarray(toks), jnp.asarray(fr))
    with torch.inference_mode():
        got, aux = port.apply(torch.from_numpy(toks), torch.from_numpy(fr))
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    assert float(aux) == float(raux) == 0.0
    got, want = _np(got.float()), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL[dtype])
        return
    rows = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want,
                                                                axis=-1)
    assert rows.max() <= BF16_ROW_L2, rows.max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_greedy_decode_past_max_position():
    """init_cache (cross K/V against the reference's) and 72 greedy
    decode_step calls (past the 64 learned positions: the table wraps)
    against the reference's, both fed the reference's greedy tokens; then
    the port's steps against its own teacher-forced decoder on those
    tokens (72 positions: the plain route)."""
    rmodel, params, port = _models("float32")
    fr = _frames(seed=4)
    enc_r = rmodel.encode(params, jnp.asarray(fr))
    rcache = rmodel.init_cache(params, enc_r, 80)
    with torch.inference_mode():
        enc_p = port.encode(torch.from_numpy(fr))
        pcache = port.init_cache(enc_p, 80)
    for layer in range(len(port.decoder)):
        for mine, theirs in ((pcache.cross_k[layer], rcache.cross_k[layer]),
                             (pcache.cross_v[layer], rcache.cross_v[layer])):
            np.testing.assert_allclose(_np(mine), _np(theirs), atol=1e-4,
                                       rtol=1e-4)
    step = jax.jit(rmodel.decode_step)
    tok = np.full((B, 1), 7, np.int32)
    fed, outs = [], []
    for t in range(72):
        fed.append(tok)
        want, rcache = step(params, rcache, jnp.asarray(tok),
                            jnp.full((B,), t, jnp.int32))
        with torch.inference_mode():
            got, pcache = port.decode_step(
                pcache, torch.from_numpy(tok),
                torch.full((B,), t, dtype=torch.int32))
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"step {t}",
                                   **DECODE_TOL)
        outs.append(got[:, 0])
        tok = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)[:, None]
    with torch.inference_mode():
        full = port.decode_train(torch.from_numpy(np.concatenate(fed, 1)),
                                 enc_p)
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               **TOL["bfloat16"])


def test_remat_gives_the_same_gradients():
    """remat="block" recomputes each block in the backward: the loss and
    every gradient equal those without it."""
    cfg = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                              dtype="float32")
    grads = []
    for remat in ("none", "block"):
        model = cast_tree(build_model(cfg, ParallelConfig(remat=remat),
                                      device="cpu", seed=0), torch.float32)
        logits, _ = model.apply(torch.from_numpy(_tokens(32)),
                                torch.from_numpy(_frames()))
        logits.float().logsumexp(-1).mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-6,
                                   msg=name)
