"""The port's M-RoPE path (``layers.apply_mrope``, ``attention.project_qkv``
and ``mask_positions``, ``LM.apply(embeds=..., positions=[B, S, 3])``)
against the JAX package, on qwen2-vl's SMOKE config (2 layers, heads 4/2
of 32, sections 4/6/6).

The reference's parameters are carried into the port by
``params_from_reference``.  Two position layouts feed the prefill:

- *grid*: t = arange, h and w a 2-D grid's rows and columns (each band of
  the rotation sees another stream); plain and flash routes compute the
  same function there, since the flash kernel assumes t = arange;
- *image*: text, then an 8 x 8 image whose patches share one t (and see
  each other: the plain route masks by t), then text again, as Qwen2-VL
  numbers them; plain route only.

Tolerances as for the dense model: float32 at rtol 1e-4, atol 1e-3 (logits
up to ~50), bf16 at the reference's atol 0.15, rtol 0.1; float32 decode
(bf16 KV caches) at atol 1e-2, rtol 1e-4.  A prefill whose positions are
not [B, S, 3] raises ``ValueError`` in the port (the reference's mask then
stops being causal: ROADMAP queue 3).  The engine is held to the
reference's in ``tests/test_torch_serve.py::test_family_engines_match``.
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
from repro.models import layers as r_layers  # noqa: E402
from repro.models.params import cast_tree as r_cast_tree  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import (build_model, params_from_reference,  # noqa: E402,E501
                                params_to_reference)
from repro_torch.models import layers as P_layers  # noqa: E402
from repro_torch.models.params import cast_tree  # noqa: E402

ARCH = "qwen2_vl_2b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
       "bfloat16": dict(rtol=0.1, atol=0.15)}
DECODE_TOL = dict(rtol=1e-4, atol=1e-2)
B, S = 2, 128           # a multiple of flash's 128 rows


def _np(x):
    return np.asarray(x, np.float32)


def _positions(layout: str, n: int = S) -> np.ndarray:
    """[B, n, 3] int32 (t, h, w) ids."""
    s = np.arange(n)
    if layout == "grid":
        tri = np.stack([s, 3 + s // 16, 7 + s % 16], -1)
    elif layout == "text":
        tri = np.stack([s, s, s], -1)
    else:                   # text 0-15, an 8 x 8 image, text again
        tri = np.stack([s, s, s], -1)
        img = np.arange(64)
        tri[16:80] = np.stack([np.full(64, 16), 16 + img // 8,
                               16 + img % 8], -1)
        tri[80:] = (24 + np.arange(n - 80))[:, None]
    return np.broadcast_to(tri, (B, n, 3)).astype(np.int32).copy()


@functools.lru_cache(maxsize=None)
def _reference():
    with jax.threefry_partitionable(False):
        params = r_build_model(r_registry.get_config(ARCH, smoke=True)).init(
            jax.random.PRNGKey(0))
    return params, jax.tree.map(_np, params)


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


def _embeds(n=S, seed=0):
    d = registry.get_config(ARCH, smoke=True).d_model
    return np.random.default_rng(seed).standard_normal(
        (B, n, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope(dtype):
    """Random (t, h, w) triples up to 32,768 at qwen2-vl's full head dim
    (128, sections 16/24/24, theta 1e6) and the smoke one (32, 4/6/6)."""
    rng = np.random.default_rng(1)
    for hd, sections, theta in ((128, (16, 24, 24), 1e6),
                                (32, (4, 6, 6), 1e4)):
        x = rng.standard_normal((B, 48, 3, hd)).astype(np.float32)
        pos = rng.integers(0, 32768, (B, 48, 3)).astype(np.int32)
        want = r_layers.apply_mrope(jnp.asarray(x, getattr(jnp, dtype)),
                                    jnp.asarray(pos), theta, sections)
        got = P_layers.apply_mrope(
            torch.from_numpy(x).to(getattr(torch, dtype)),
            torch.from_numpy(pos), theta, sections)
        assert got.dtype == getattr(torch, dtype)
        tol = 1e-4 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(_np(got.float()), _np(want), atol=tol,
                                   rtol=tol, err_msg=str(hd))


@pytest.mark.parametrize("layout", ["grid", "image"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_apply_plain(dtype, layout):
    rmodel, params, port = _models(dtype)
    emb, pos = _embeds(), _positions(layout)
    want, _ = rmodel.apply(params, positions=jnp.asarray(pos),
                           embeds=jnp.asarray(emb))
    with torch.inference_mode():
        got, aux = port.apply(positions=torch.from_numpy(pos),
                              embeds=torch.from_numpy(emb))
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got.float()), _np(want), **TOL[dtype])


def test_lm_apply_flash():
    """The flash route (the kernel's plain version here; the reference's
    Pallas kernel in interpret mode) with t = arange: against the
    reference's flash route and the port's plain route."""
    rmodel, params, port = _models("float32", use_flash=True)
    emb, pos = _embeds(seed=2), _positions("grid")
    want, _ = rmodel.apply(params, positions=jnp.asarray(pos),
                           embeds=jnp.asarray(emb))
    with torch.inference_mode():
        got, _ = port.apply(positions=torch.from_numpy(pos),
                            embeds=torch.from_numpy(emb))
        port.use_flash = False
        plain, _ = port.apply(positions=torch.from_numpy(pos),
                              embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    np.testing.assert_allclose(_np(got), _np(plain), **TOL["float32"])


@pytest.mark.parametrize("positions", ["[B, S]", "none"])
def test_prefill_without_triples_raises(positions):
    model = build_model(registry.get_config(ARCH, smoke=True), device="cpu")
    pos = (None if positions == "none" else
           torch.arange(S, dtype=torch.int32).expand(B, S))
    with pytest.raises(ValueError, match=r"\[B, S, 3\]"):
        model.apply(positions=pos, embeds=torch.from_numpy(_embeds()))


def test_decode_step():
    """12 text tokens decoded on both sides in float32 (decode's [B]
    positions stand for t = h = w)."""
    rmodel, params, port = _models("float32")
    toks = np.random.default_rng(3).integers(0, 512, (B, 12)).astype(
        np.int32)
    rcache, pcache = rmodel.init_cache(B, 16), port.init_cache(B, 16)
    step = jax.jit(rmodel.decode_step)
    for t in range(toks.shape[1]):
        want, rcache = step(params, rcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.full((B,), t, jnp.int32))
        with torch.inference_mode():
            got, pcache = port.decode_step(
                pcache, torch.from_numpy(toks[:, t:t + 1]),
                torch.full((B,), t, dtype=torch.int32))
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"token {t}",
                                   **DECODE_TOL)


def test_decode_matches_prefill_and_round_trip():
    """Text tokens decoded token by token against their prefill with t =
    h = w positions (bf16, the reference's model tolerance); the
    parameters come back to the reference's tree exactly."""
    _, tree = _reference()
    model = params_from_reference(registry.get_config(ARCH, smoke=True),
                                  tree, "cpu")
    T = 12
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 512, (B, T)))
    with torch.inference_mode():
        full, _ = model.apply(toks, positions=torch.from_numpy(
            _positions("text", T)))
        cache = model.init_cache(B, 16)
        outs = []
        for t in range(T):
            lg, cache = model.decode_step(cache, toks[:, t:t + 1],
                                          torch.full((B,), t))
            outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1).float()),
                               _np(full.float()), **TOL["bfloat16"])
    back = params_to_reference(model)
    for path, want in jax.tree_util.tree_leaves_with_path(tree):
        have = back
        for k in path:
            have = have[k.key]
        np.testing.assert_array_equal(have, want,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("S", [3, 4, 8])
def test_reference_prefill_without_triples_is_not_causal(S):
    """Why the port raises: the reference's M-RoPE prefill at batch 1 with
    [1, S] positions masks by ``positions[..., 0]``, a [1] vector, so
    token 0 sees the last token (its logits move when the last token
    changes: by 11.8, 6.6, 3.4 at S 3, 4, 8 on this config); with [1, S,
    3] positions they do not move."""
    rmodel = r_build_model(r_registry.get_config(ARCH, smoke=True))
    params = _reference()[0]
    toks = np.random.default_rng(0).integers(0, 512, (1, S)).astype(
        np.int32)
    other = toks.copy()
    other[0, -1] = (other[0, -1] + 1) % 512
    moved = {}
    for kind, pos in (("[1, S]", np.arange(S, dtype=np.int32)[None]),
                      ("[1, S, 3]", _positions("text", S)[:1])):
        a, _ = rmodel.apply(params, jnp.asarray(toks),
                            positions=jnp.asarray(pos))
        b, _ = rmodel.apply(params, jnp.asarray(other),
                            positions=jnp.asarray(pos))
        moved[kind] = float(np.abs(_np(a[0, 0]) - _np(b[0, 0])).max())
    assert moved["[1, S]"] > 1.0 and moved["[1, S, 3]"] == 0.0, moved
