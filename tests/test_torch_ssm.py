"""The port's Mamba-2 model path against the JAX package, on mamba2-130m's
SMOKE config (2 layers, d_model 128, 8 heads of 32, state 32, chunk 32).

The reference's parameters (``model.init(PRNGKey(0))``) are carried into
the port by ``params_from_reference``.  Compared with the reference's:

- ``ssm_block`` through the kernel route (the reference's Pallas kernel in
  interpret mode; the port's plain version of its kernel on the CPU) and
  the plain route, on S = 80 (ragged: padded to 96), ``ssm_decode`` over 6
  steps with its caches, ``init_ssm_cache``, ``LM.apply`` (both routes) and
  ``decode_step`` (16 tokens, caches after), in float32 (weights cast on
  both sides) at rtol 1e-4 with atol 1e-5 for a block, 1e-3 for logits
  (the danube tests' float32 tolerance); ``LM.apply`` also in bf16 at the
  reference's own bf16 tolerance for this model, atol 0.3, rtol 0.15
  (``tests/test_models.py:127-130``): the projections' bf16 products round
  one ulp apart on the two sides here and there (the conv's bf16 sums
  agree bit for bit), which moves 9 of 81,920 logits by up to 0.22
  (measured).  In float32 the reference's conv window turns float32 at its
  first decode step (the concatenation promotes it), and the port's
  float32 model keeps it in float32 from the start, so decode is held as
  tightly as prefill.
- Decode against prefill (``tests/test_models.py:113-130``): atol 0.3,
  rtol 0.15, in bf16.
- ``ServeEngine`` on both sides (float32, 4 slots, 6 requests of 3-12
  prompt tokens, 6 new tokens each, so slots are reused): every decode
  call's logits at rtol 1e-4, atol 1e-3, the same tokens, and the same
  final SSM states and conv windows at rtol 1e-4, atol 1e-5: this pins the
  reference's slot behaviour (no cache reset on admission; token-0 steps
  of the other slots during a prompt), which the port reproduces.
- One training step's gradients on the plain route against ``jax.grad`` of
  the reference's loss, in float32, per leaf at the float32 tolerance of
  ``tests/test_torch_train.py`` (atol 5e-5, rtol 1e-4); the kernel route
  raises under autograd, as the reference has no backward for it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.config import ServeConfig as RServeConfig  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.models import ssm as r_ssm  # noqa: E402
from repro.models.params import cast_tree as r_cast_tree  # noqa: E402
from repro.runtime.serve import Request as RRequest  # noqa: E402
from repro.runtime.serve import ServeEngine as RServeEngine  # noqa: E402
from repro.runtime.train import make_loss_fn as r_make_loss_fn  # noqa: E402

from repro_torch.config import (  # noqa: E402
    ParallelConfig, ServeConfig, TrainConfig)
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import (  # noqa: E402
    build_model, params_from_reference, params_to_reference)
from repro_torch.models import ssm as P_ssm  # noqa: E402
from repro_torch.models.params import cast_tree  # noqa: E402
from repro_torch.optim import init_opt_state  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    Request, ServeEngine, make_loss_fn, make_train_step)

ARCH = "mamba2_130m"
TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
       "bfloat16": dict(rtol=0.15, atol=0.3)}
BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=5e-5)
B, S = 2, 80


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def reference():
    """The reference's mamba2 SMOKE parameters and their float32 numpy
    tree."""
    cfg = r_registry.get_config(ARCH, smoke=True)
    with jax.threefry_partitionable(False):
        params = r_build_model(cfg).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(_np, params)


@pytest.fixture(scope="module")
def tokens():
    cfg = registry.get_config(ARCH, smoke=True)
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _configs(dtype):
    return (dataclasses.replace(r_registry.get_config(ARCH, smoke=True),
                                dtype=dtype),
            dataclasses.replace(registry.get_config(ARCH, smoke=True),
                                dtype=dtype))


def _models(reference, dtype, use_kernel=False):
    """(reference model, its params, port model) in ``dtype``."""
    params, tree = reference
    rc, pc = _configs(dtype)
    port = params_from_reference(pc, tree, "cpu", use_ssd_kernel=use_kernel)
    if dtype == "float32":
        params = r_cast_tree(params, jnp.float32)
        cast_tree(port, torch.float32)
    return r_build_model(rc, use_ssd_kernel=use_kernel), params, port


def _layer0(tree):
    return {k: v[0] for k, v in tree["block_0"]["ssm"].items()}


# ------------------------------------------------------------- the mixer


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_block(reference, use_kernel):
    rc, pc = _configs("float32")
    p = _layer0(reference[1])
    x = np.random.default_rng(1).standard_normal(
        (B, S, rc.d_model)).astype(np.float32)
    want = r_ssm.ssm_block({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), rc, use_kernel=use_kernel)
    with torch.no_grad():
        got = P_ssm.ssm_block({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), pc, use_kernel=use_kernel)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **BLOCK_TOL)


def test_ssm_decode(reference):
    rc, pc = _configs("float32")
    p = _layer0(reference[1])
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    pp = {k: torch.from_numpy(v) for k, v in p.items()}
    rcache = r_ssm.init_ssm_cache(rc, B, 1)
    pcache = P_ssm.init_ssm_cache(pc, B, 1)
    xs = np.random.default_rng(2).standard_normal(
        (6, B, 1, rc.d_model)).astype(np.float32)
    for t, x in enumerate(xs):
        want, rcache = r_ssm.ssm_decode(rp, jnp.asarray(x), rc, rcache)
        got, pcache = P_ssm.ssm_decode(pp, torch.from_numpy(x), pc, pcache)
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"step {t}",
                                   **BLOCK_TOL)
        np.testing.assert_allclose(_np(pcache.state), _np(rcache.state),
                                   **BLOCK_TOL)
        np.testing.assert_array_equal(_np(pcache.conv), _np(rcache.conv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_ssm_cache(dtype):
    rc, pc = _configs(dtype)
    want = r_ssm.init_ssm_cache(rc, 3, 1)
    got = P_ssm.init_ssm_cache(pc, 3, 1, "cpu")
    assert got.conv.shape == want.conv.shape
    assert got.state.shape == want.state.shape
    assert got.state.dtype == torch.float32
    # bf16 as the reference allocates it; float32 for a float32 model,
    # the dtype the reference's window takes at its first step
    assert got.conv.dtype == getattr(torch, dtype)
    assert not got.conv.any() and not got.state.any()


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_apply(reference, tokens, dtype, use_kernel):
    rmodel, params, port = _models(reference, dtype, use_kernel)
    want, _ = rmodel.apply(params, jnp.asarray(tokens))
    with torch.inference_mode():
        got, aux = port.apply(torch.from_numpy(tokens))
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got.float()), _np(want), **TOL[dtype])


def test_decode_step(reference, tokens):
    rmodel, params, port = _models(reference, "float32")
    rcache = rmodel.init_cache(B, 32)
    pcache = port.init_cache(B, 32)
    step = jax.jit(rmodel.decode_step)
    for t in range(16):
        want, rcache = step(params, rcache, jnp.asarray(tokens[:, t:t + 1]),
                            jnp.full((B,), t, jnp.int32))
        with torch.inference_mode():
            got, pcache = port.decode_step(
                pcache, torch.from_numpy(tokens[:, t:t + 1]),
                torch.full((B,), t, dtype=torch.int32))
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"token {t}",
                                   **TOL["float32"])
    for layer, c in enumerate(pcache):
        np.testing.assert_allclose(_np(c.state),
                                   _np(rcache["block_0"].state[layer]),
                                   **BLOCK_TOL)
        np.testing.assert_allclose(_np(c.conv),
                                   _np(rcache["block_0"].conv[layer]),
                                   **BLOCK_TOL)


def test_decode_matches_prefill_ssm():
    """Cached decode == teacher-forced forward (the port of the reference's
    test of the same name): bf16 weights, the chunked scan against the
    per-token recurrence."""
    cfg = registry.get_config(ARCH, smoke=True)
    model = build_model(cfg, use_ssd_kernel=True, device="cpu")
    T = 16
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, T)))
    with torch.inference_mode():
        full, _ = model.apply(toks)
        cache = model.init_cache(B, 32)
        outs = []
        for t in range(T):
            lg, cache = model.decode_step(cache, toks[:, t:t + 1],
                                          torch.full((B,), t))
            outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(_np(dec.float()), _np(full.float()),
                               atol=0.3, rtol=0.15)


def test_params_round_trip(reference):
    _, tree = reference
    model = params_from_reference(registry.get_config(ARCH, smoke=True),
                                  tree, "cpu")
    assert model.blocks[0].ssm["A_log"].dtype == torch.float32
    assert model.blocks[0].ssm["wz"].dtype == torch.bfloat16
    back = params_to_reference(model)
    want = jax.tree_util.tree_leaves_with_path(tree)
    assert len(want) == len(jax.tree.leaves(back))
    for path, leaf in want:
        have = back
        for k in path:
            have = have[k.key]
        np.testing.assert_array_equal(have, leaf,
                                      err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------- serving

N_REQ, NEW, SLOTS = 6, 6, 4


def _requests():
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, 512, int(rng.integers(3, 13))).astype(
        np.int32)) for i in range(N_REQ)]


def test_serve_engines_match(reference):
    """Both engines drain the same requests with the same weights; every
    decode call's logits, the generated tokens and the final SSM caches
    agree."""
    params, tree = reference
    rc, pc = _configs("float32")
    reng = RServeEngine(r_build_model(rc), rc,
                        RServeConfig(batch=SLOTS, max_seq=64),
                        r_cast_tree(params, jnp.float32))
    rlog = []
    rdecode = reng._decode

    def rrec(p, cache, toks, pos):
        logits, cache = rdecode(p, cache, toks, pos)
        rlog.append(np.asarray(logits, np.float32))
        return logits, cache

    reng._decode = rrec
    rreqs = [RRequest(i, p, max_new_tokens=NEW) for i, p in _requests()]
    for r in rreqs:
        reng.submit(r)
    assert len(reng.run_until_drained()) == N_REQ

    model = cast_tree(params_from_reference(pc, tree, "cpu"), torch.float32)
    peng = ServeEngine(model, ServeConfig(batch=SLOTS, max_seq=64),
                       device="cpu")
    plog = []
    pdecode = peng._decode

    def prec(toks):
        logits = pdecode(toks)
        plog.append(logits.float().numpy())
        return logits

    peng._decode = prec
    preqs = [Request(i, p, max_new_tokens=NEW) for i, p in _requests()]
    for r in preqs:
        peng.submit(r)
    assert len(peng.run_until_drained()) == N_REQ

    assert len(plog) == len(rlog) > sum(len(p) for _, p in _requests())
    for i, (pl, rl) in enumerate(zip(plog, rlog)):
        np.testing.assert_allclose(pl, rl, err_msg=f"decode call {i}",
                                   **TOL["float32"])
    assert [(r.rid, r.out) for r in rreqs] == [(r.rid, r.out) for r in preqs]
    for layer, c in enumerate(peng.cache):
        np.testing.assert_allclose(_np(c.state),
                                   _np(reng.cache["block_0"].state[layer]),
                                   **BLOCK_TOL)
        np.testing.assert_allclose(_np(c.conv),
                                   _np(reng.cache["block_0"].conv[layer]),
                                   **BLOCK_TOL)


# ------------------------------------------------------------- training


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, 64)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def test_gradients_match_reference(reference):
    """One step's gradients on the plain route (two chunks, so the state
    carry is differentiated) against ``jax.grad`` of the reference's loss,
    per leaf, in float32."""
    rmodel, params, port = _models(reference, "float32")
    rc, pc = _configs("float32")
    toks, labs = _batch(pc)
    want = jax.grad(r_make_loss_fn(rmodel, rc))(
        params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    loss = make_loss_fn(port, pc)({"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labs)})
    plist = list(port.parameters())
    grads = torch.autograd.grad(loss, plist)
    with torch.no_grad():           # the gradients in the reference's layout
        for p, g in zip(plist, grads):
            p.copy_(g)
    got = params_to_reference(port)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        have = got
        for k in path:
            have = have[k.key]
        np.testing.assert_allclose(have, _np(w),
                                   err_msg=jax.tree_util.keystr(path),
                                   **GRAD_TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_train_step(use_kernel):
    """make_train_step on mamba: the plain route trains (finite losses,
    every parameter moves by step 1); the kernel route raises
    NotImplementedError."""
    cfg = registry.get_config(ARCH, smoke=True)
    model = build_model(cfg, use_ssd_kernel=use_kernel, device="cpu")
    tcfg = TrainConfig(global_batch=B, seq_len=64, lr=1e-2, warmup_steps=1,
                       total_steps=10)
    step = make_train_step(model, cfg, tcfg, ParallelConfig())
    opt = init_opt_state(dict(model.named_parameters()), tcfg)
    toks, labs = _batch(cfg)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)}
    if use_kernel:
        with pytest.raises(NotImplementedError, match="SSD backward"):
            step(opt, batch)
        return
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for _ in range(2):              # step 0 has lr 0 (warmup)
        opt, met = step(opt, batch)
        assert np.isfinite(float(met["loss"]))
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p, before[n])]
    assert len(moved) == len(before), set(before) - set(moved)
