"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``moe_block`` on the same numpy inputs from a seed.

- float32, capacity factor 8.0 (nothing drops) and 1.0 (some assignments
  drop at their expert's capacity, counted from the expert buffer's
  slots),
  swiglu, gelu and relu2, with and without a shared expert: outputs at
  2e-5 (``tests/test_moe.py``'s tolerance), the aux loss at rtol 1e-6;
- bf16 at the model tolerance (atol 0.15, rtol 0.1 of
  ``tests/test_models.py``; seen far below it);
- a decode-sized step (8 tokens, granite's 32 experts top-8 at 1.25,
  C_loc = 4) whose crowded experts drop;
- the chunked dispatch over two chunks (``DISPATCH_CHUNK`` lowered on both
  sides), aux summed over chunks;
- gradients of x, router, wi and wo against ``jax.grad`` of
  ``sum(y * cotangent) + aux``, with and without drops;
- the dense all-experts check of ``tests/test_moe.py``, the top-k order on
  ties and the bucket ranks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import repro.models.moe as R  # noqa: E402
from repro.config import ModelConfig as RModelConfig  # noqa: E402
from repro.config import MoEConfig as RMoEConfig  # noqa: E402

import repro_torch.models.moe as P  # noqa: E402
from repro_torch.config import ModelConfig, MoEConfig  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=0.15, rtol=0.1)


def _cfgs(E=8, k=2, cf=8.0, act="swiglu", shared=0, d=32, f=16):
    kw = dict(name="moe-test", family="moe", num_layers=1, d_model=d,
              num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=64,
              activation=act)
    mk = dict(num_experts=E, experts_per_token=k, d_ff_expert=f,
              capacity_factor=cf, shared_expert_d_ff=shared)
    return (RModelConfig(**kw, moe=RMoEConfig(**mk)),
            ModelConfig(**kw, moe=MoEConfig(**mk)))


def _params(cfg, seed=0):
    """Numpy parameters at the reference's init scales (router 0.02 would
    make the gates near-uniform, so it is drawn wider)."""
    m, d = cfg.moe, cfg.d_model
    rng = np.random.default_rng(seed)
    n_in = 2 if cfg.activation == "swiglu" else 1

    def w(*shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    p = {"router": w(d, m.num_experts, fan=d / 4),
         "wi": w(m.num_experts, d, n_in, m.d_ff_expert, fan=d),
         "wo": w(m.num_experts, m.d_ff_expert, d, fan=m.d_ff_expert)}
    if m.shared_expert_d_ff:
        p["shared_wi"] = w(d, n_in, m.shared_expert_d_ff, fan=d)
        p["shared_wo"] = w(m.shared_expert_d_ff, d, fan=m.shared_expert_d_ff)
    return p


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(p, x, rc, pc, dtype="float32"):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jd)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else td)
          for k, v in p.items()}
    want, raux = R.moe_block(rp, jnp.asarray(x, jd), rc)
    got, aux = P.moe_block(tp, torch.from_numpy(x).to(td), pc)
    assert got.dtype == td and aux.dtype == torch.float32
    return (np.asarray(want, np.float32), float(raux),
            got.float().numpy(), float(aux))


def _dropped(p, x, pc):
    """The port's assignments dropped at capacity, over x's tokens: those
    its expert buffer does not keep."""
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    _, idx, _ = P._route(xt, torch.from_numpy(p["router"]), pc)
    ekeep, _ = P._slots(idx.reshape(-1), pc, xt.shape[0])
    return idx.numel() - int(ekeep.sum())


@pytest.mark.parametrize("shared", [0, 24], ids=["routed", "shared"])
@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
@pytest.mark.parametrize("cf", [8.0, 1.0], ids=["cf8", "cf1-drops"])
def test_moe_block_matches_reference(cf, act, shared):
    rc, pc = _cfgs(cf=cf, act=act, shared=shared)
    p, x = _params(pc), _x((2, 16, 32))
    want, raux, got, aux = _both(p, x, rc, pc)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, raux, rtol=1e-6)
    dropped = _dropped(p, x, pc)
    assert (dropped > 0) == (cf == 1.0), dropped


@pytest.mark.parametrize("cf", [8.0, 1.0], ids=["cf8", "cf1-drops"])
def test_moe_block_bf16(cf):
    rc, pc = _cfgs(cf=cf, shared=24)
    p, x = _params(pc), _x((2, 16, 32))
    want, raux, got, aux = _both(p, x, rc, pc, "bfloat16")
    np.testing.assert_allclose(got, want, **BF16_TOL)
    np.testing.assert_allclose(aux, raux, rtol=1e-5)


def test_decode_sized_step_drops_like_the_reference():
    """8 tokens, 32 experts top-8 at capacity factor 1.25 (granite's):
    C_send 80, C_loc 4.  Five tokens are the same (slots fed token 0), so
    their 8 experts each get at least 5 > 4 assignments: every expert's
    assignments past its 4th (in flat order) drop, counted here from the
    reference's own routing."""
    rc, pc = _cfgs(E=32, k=8, cf=1.25, d=64, f=32)
    assert P.capacities(pc, 8) == (80, 4)
    p = _params(pc)
    x = _x((8, 1, 64))
    x[3:] = x[3]
    want, raux, got, aux = _both(p, x, rc, pc)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, raux, rtol=1e-6)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(8, 64)) @ p["router"], -1)
    n_e = np.bincount(np.asarray(jax.lax.top_k(probs, 8)[1]).ravel(),
                      minlength=32)
    assert n_e.max() >= 5
    assert _dropped(p, x, pc) == np.maximum(n_e - 4, 0).sum()
    # one token alone drops nothing (C_loc = 1, k distinct experts)
    assert P.capacities(pc, 1) == (10, 1)
    assert _dropped(p, x[:1], pc) == 0


@pytest.mark.parametrize("T", [128, 96], ids=["two-chunks", "ragged"])
def test_chunked_dispatch(monkeypatch, T):
    """DISPATCH_CHUNK lowered to 64 on both sides: 128 tokens run as two
    chunks (aux summed), 96 as one (not a multiple)."""
    monkeypatch.setattr(R, "DISPATCH_CHUNK", 64)
    monkeypatch.setattr(P, "DISPATCH_CHUNK", 64)
    rc, pc = _cfgs(cf=1.0)
    p, x = _params(pc), _x((2, T // 2, 32))
    want, raux, got, aux = _both(p, x, rc, pc)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, raux, rtol=1e-6)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x.reshape(-1, 32))
    parts = [P._moe_chunk(xt[i:i + 64], tp["router"], tp["wi"], tp["wo"], pc)
             for i in range(0, T, 64)] if T % 64 == 0 else \
        [P._moe_chunk(xt, tp["router"], tp["wi"], tp["wo"], pc)]
    np.testing.assert_array_equal(
        torch.cat([y for y, _ in parts]).numpy(), got.reshape(-1, 32))
    assert aux == pytest.approx(float(sum(a for _, a in parts)), rel=1e-6)


@pytest.mark.parametrize("cf", [8.0, 1.0], ids=["cf8", "cf1-drops"])
def test_gradients_match_jax(cf):
    rc, pc = _cfgs(cf=cf, shared=24)
    p, x = _params(pc), _x((2, 16, 32))
    cot = _x((2, 16, 32), seed=2)

    def r_loss(params, xv):
        y, aux = R.moe_block(params, xv, rc)
        return jnp.sum(y * cot) + aux

    want = jax.grad(r_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = P.moe_block(tp, tx, pc)
    (y * torch.from_numpy(cot)).sum().add(aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[1]), **TOL)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(want[0][k]),
                                   err_msg=k, **TOL)
    # the aux loss alone reaches the router, through mean(probs) only
    tr = torch.from_numpy(p["router"]).requires_grad_()
    _, aux = P.moe_block({**{k: torch.from_numpy(v) for k, v in p.items()},
                          "router": tr}, torch.from_numpy(x), pc)
    aux.backward()
    r_aux = jax.grad(lambda r: R.moe_block(
        {**{k: jnp.asarray(v) for k, v in p.items()}, "router": r},
        jnp.asarray(x), rc)[1])(jnp.asarray(p["router"]))
    assert np.abs(np.asarray(r_aux)).max() > 0
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(r_aux), **TOL)


def test_matches_dense_all_experts():
    """tests/test_moe.py's check: with nothing dropped, the dispatch equals
    every expert run densely and combined with the top-k gates."""
    _, pc = _cfgs(cf=8.0)
    p = {k: torch.from_numpy(v) for k, v in _params(pc).items()}
    x = torch.from_numpy(_x((2, 16, 32)))
    y, aux = P.moe_block(p, x, pc)
    xt = x.reshape(-1, 32)
    probs = torch.softmax(xt @ p["router"], -1)
    gates, idx = torch.topk(probs, 2)
    gates = gates / gates.sum(-1, keepdim=True)
    h = torch.einsum("td,edif->teif", xt, p["wi"])
    a = torch.nn.functional.silu(h[..., 0, :]) * h[..., 1, :]
    ye = torch.einsum("tef,efd->ted", a, p["wo"])
    sel = torch.take_along_dim(ye, idx[..., None], dim=1)
    dense = (sel * gates[..., None]).sum(1).reshape(2, 16, 32)
    np.testing.assert_allclose(y.numpy(), dense.numpy(), **TOL)
    assert float(aux) > 0


def test_top_k_order_on_ties():
    """jax.lax.top_k: descending, the lower index first among equals."""
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.0],
                      [0.25, 0.25, 0.25, 0.25, 0.0, 0.0],
                      [0.0, 0.0, 0.0, 0.0, 0.5, 0.5]], np.float32)
    for k in (1, 2, 3, 4):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = P.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_rank_in_bucket_matches_reference():
    ids = np.random.default_rng(3).integers(0, 5, 300).astype(np.int32)
    want = R._rank_in_bucket(jnp.asarray(ids), 5)
    got = P._rank_in_bucket(torch.from_numpy(ids), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_spec_matches_reference():
    """Shapes, dtypes and initializers of the expert leaves, shared expert
    included, with the stacked layer axis of the reference."""
    rc, pc = _cfgs(shared=24)
    want = R.moe_spec(rc, 3)
    got = P.moe_spec(pc, 3)
    assert set(want) == set(got)
    for k, s in got.items():
        r = want[k]
        assert (3,) + s.shape == r.shape and s.stack == 3, k
        assert (s.init, s.scale) == (r.init, r.scale), k
        assert str(s.dtype).split(".")[-1] == jnp.dtype(r.dtype).name, k


def test_decode_coupling_config_numbers():
    """granite's decode capacities at 8 slots (ROADMAP "Known
    behaviours"): C_send = ceil(8 * 8 * 1.25) = 80, C_loc = 4."""
    from repro_torch.configs import registry
    cfg = registry.get_config("granite_moe_1b_a400m")
    assert P.capacities(cfg, 8) == (80, 4)
    assert P.capacities(cfg, 1) == (10, 1)
    assert P.capacities(cfg, P.DISPATCH_CHUNK) == (81920, 3200)
