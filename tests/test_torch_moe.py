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
  ties and the bucket ranks;
- the expert-parallel case of ``tests/test_moe.py:71-107``: ``moe_block``
  under a (data 2, model 4) mesh (the CPU named 8 times; ``all_to_all``
  over ``model``) against the reference's on 8 virtual devices (a child
  python, once for the file, as jax fixes its device count at its first
  import) and against the port's one-device path, at 1e-4; also with
  drops (capacity 1.0, against the reference's mesh run) and at a decode
  step (S 1: tokens replicated over ``model``); granite's SMOKE LM built
  under that mesh on both sides, logits and aux at 1e-4.
"""
import os
import subprocess
import sys
from pathlib import Path

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


# ------------------------------------------------ expert-parallel dispatch

EP_CASES = {"cf8": (8.0, (4, 16, 32)), "cf1-drops": (1.0, (4, 16, 32)),
            "decode": (8.0, (4, 1, 32))}
EP_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.config import ModelConfig, MoEConfig
from repro.models.moe import moe_block
from repro.parallel.sharding import make_rules

inp = dict(np.load(sys.argv[1]))
out = {}
mesh = make_mesh((2, 4), ("data", "model"))
with jax.threefry_partitionable(False):
    for name, cf in %r:
        cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=32,
                          num_heads=4, num_kv_heads=4, d_ff=0,
                          vocab_size=64,
                          moe=MoEConfig(num_experts=8, experts_per_token=2,
                                        d_ff_expert=16, capacity_factor=cf))
        p = {k: jnp.asarray(inp[k]) for k in ("router", "wi", "wo")}
        x = jnp.asarray(inp[f"x/{name}"])
        y1, a1 = moe_block(p, x, cfg)
        y8, a8 = jax.jit(lambda p, v: moe_block(p, v, cfg, make_rules(),
                                                mesh))(p, x)
        out[f"{name}/y1"], out[f"{name}/aux1"] = np.asarray(y1), np.asarray(a1)
        out[f"{name}/y8"], out[f"{name}/aux8"] = np.asarray(y8), np.asarray(a8)
    # the whole MoE LM under the mesh (granite's SMOKE config, float32)
    import dataclasses
    from repro.configs import registry
    from repro.models import build_model
    from repro.models.params import cast_tree
    lcfg = dataclasses.replace(registry.get_config(
        "granite_moe_1b_a400m", smoke=True), dtype="float32")
    lm = build_model(lcfg, mesh=mesh)
    params = cast_tree(lm.init(jax.random.PRNGKey(0)), jnp.float32)
    logits, aux = jax.jit(lm.apply)(params, jnp.asarray(inp["tokens"]))
    out["lm/logits"], out["lm/aux"] = np.asarray(logits), np.asarray(aux)
    for p, v in jax.tree_util.tree_leaves_with_path(params):
        out["lm/p" + jax.tree_util.keystr(p)] = np.asarray(v, np.float32)
np.savez(sys.argv[2], **out)
print("REFERENCE_DONE")
""" % ([(k, v[0]) for k, v in EP_CASES.items()],)


@pytest.fixture(scope="module")
def ep_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep")
    _, pc = _cfgs()
    inp = dict(_params(pc))
    for name, (_, shape) in EP_CASES.items():
        inp[f"x/{name}"] = _x(shape)
    inp["tokens"] = np.random.default_rng(2).integers(0, 512, (4, 32)).astype(
        np.int32)
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", EP_SCRIPT, str(d / "in.npz"),
                        str(d / "out.npz")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_DONE" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]
    return inp, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("case", list(EP_CASES))
def test_expert_parallel_matches_reference(ep_data, case):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.parallel.spmd import ppermute
    inp, ref = ep_data
    cf, _ = EP_CASES[case]
    _, pc = _cfgs(cf=cf)
    p = {k: torch.from_numpy(inp[k]) for k in ("router", "wi", "wo")}
    x = torch.from_numpy(inp[f"x/{case}"])
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    ppermute.counts.clear()
    y8, a8 = P.moe_block(p, x, pc, make_rules(), mesh)
    assert not ppermute.counts          # all_to_all, no ring steps
    y1, a1 = P.moe_block(p, x, pc)
    np.testing.assert_allclose(y8.numpy(), ref[f"{case}/y8"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(a8), ref[f"{case}/aux8"], rtol=1e-5)
    np.testing.assert_allclose(y1.numpy(), ref[f"{case}/y1"], atol=1e-4,
                               rtol=1e-4)
    if cf == 8.0:           # nothing drops: EP equals the one-device path
        np.testing.assert_allclose(y8.numpy(), y1.numpy(), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(ref[f"{case}/y8"], ref[f"{case}/y1"],
                                   atol=1e-4, rtol=1e-4)


def test_expert_parallel_inside_a_rank_runs_locally():
    """moe_block under a mesh, called inside a shard_map rank (the
    trainer's data-parallel step), runs the one-device path on the rank's
    tokens."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.spmd import P as Spec
    from repro_torch.parallel.spmd import shard_map
    _, pc = _cfgs()
    p = {k: torch.from_numpy(v) for k, v in _params(pc).items()}
    x = torch.from_numpy(_x((4, 16, 32)))
    mesh = make_mesh((4,), ("data",), ["cpu"] * 4)
    got = shard_map(lambda v: P.moe_block(p, v, pc, None, mesh)[0],
                    mesh=mesh, in_specs=Spec("data"),
                    out_specs=Spec("data"))(x)
    want = torch.cat([P.moe_block(p, x[i:i + 1], pc)[0] for i in range(4)])
    assert torch.equal(got, want)


def test_expert_parallel_lm_matches_reference(ep_data):
    """granite's SMOKE LM built under (data 2, model 4) on both sides: the
    port's forward (its MoE layers expert-parallel over CPU ranks, under
    no_grad: the collectives carry no gradient) gives the reference's
    logits and aux loss (float32, 1e-4)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import params_from_reference
    from repro_torch.models.params import cast_tree
    inp, ref = ep_data
    tree: dict = {}
    for key, v in ref.items():
        if key.startswith("lm/p["):
            node = tree
            path = [p.strip("'") for p in key[5:-1].split("][")]
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
    cfg = dataclasses.replace(registry.get_config("granite_moe_1b_a400m",
                                                  smoke=True),
                              dtype="float32")
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    model = cast_tree(params_from_reference(cfg, tree, "cpu", mesh=mesh),
                      torch.float32)
    with torch.no_grad():
        logits, aux = model.apply(torch.from_numpy(inp["tokens"]))
    np.testing.assert_allclose(logits.numpy(), ref["lm/logits"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(aux), ref["lm/aux"], rtol=1e-4)
