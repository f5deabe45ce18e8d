"""The port's tensor parallelism for the MoE family (granite-moe and
kimi-k2) against one device and the JAX package.

Every case runs on CPU ranks (``make_mesh(..., ["cpu"] * n)``) at smoke
width, in float32 (weights cast on both sides).  Inputs are drawn with
numpy from a seed.

- **Train step.**  granite-smoke's ``make_train_step`` on (data 2, model
  4), kimi-smoke's with ``fsdp=True`` on (2, 4) and granite-smoke's with
  ``grad_sync="ring"`` on (data 2, model 2), each against the one-device
  step on the same tree at a capacity factor that drops nothing
  (``CF_NO_DROP``: 8 experts, top-2, over at most 4 ranks), one step at
  lr 1e-3 from step 1 of the warm-up: loss and gradient norm rtol 1e-5,
  every parameter atol 5e-5 / rtol 1e-4 (``PARAM_TOL``, as
  ``tests/test_torch_tp.py``), each gradient within 1e-4 relative L2.
  The aux loss is the reference's mesh program's (``moe.py:183``): the
  ``pmean`` over the ranks of each rank's aux on its own tokens, so the
  one-device side takes its aux as that mean over the same token groups
  (``chip_smoke.py``'s ``mesh_aux``, which its *tp* phase uses on the
  card); its outputs are the one-device path's.
- **Planted fault.**  One rank (model index 1) keeps its own rows instead
  of layer 0's return ``all_to_all``: the step comparison must fail.
- ``chip_smoke.py``'s record of a step's routing (``route_log``,
  ``route_flips``, ``remat_flips``): no token routed apart from one
  device or by a remat recompute, and two ranks' records swapped, or a
  recompute's rows shifted, found.
- **Prefill at capacity factor 1.0**, where rows drop: ``LM.apply``'s
  logits and aux on (data 2, model 4) against the reference's ``LM.apply``
  on a (2, 4) mesh of 8 host devices (atol / rtol 1e-4; the reference in
  a child python, as ``tests/test_torch_moe.py``'s ``EP_SCRIPT``), and
  unlike one device's (drops follow the split).
- ``moe_block`` inside the ranks of a (2, 4) mesh against the EP path
  outside a rank (``_moe_mesh``), bit for bit; a shared expert's
  column-parallel path in the prefill against one device.
- The port's MoE parameter specs against the reference's ``spec_for``
  with FSDP on and off, and the table they give.
- Lone-rank counts, ``all-to-all`` included, against the real ranks'; a
  step's collectives by kind against ``chip_smoke.py``'s derivation
  (``tp_family_counts``).
- A depth-1 granite ``train_4k`` dry-run record on a (2, 4) meta mesh:
  partitioned, its collectives by kind and axes equal to counts derived
  from the layer count (:func:`_expected_counts`).
- A granite checkpoint saved on (2, 4) restored onto (4, 2), bit for bit.
- ``check_tp`` still raising for the MLA, VLM and encoder-decoder
  families, naming left 6 (the SSM and hybrid families:
  ``tests/test_torch_tp_ssm.py``).
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import registry as r_registry  # noqa: E402
from repro.models.moe import moe_spec as r_moe_spec  # noqa: E402
from repro.parallel.sharding import make_rules as r_make_rules  # noqa: E402
from repro.parallel.sharding import spec_for as r_spec_for  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as P_steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402,E501
from repro_torch.models import lm as P_lm  # noqa: E402
from repro_torch.models import moe as P_moe  # noqa: E402
from repro_torch.models.model import (check_tp, make_model,  # noqa: E402
                                      replicate)
from repro_torch.models.params import cast_tree  # noqa: E402
from repro_torch.optim import init_opt_state  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.parallel.sharding import (NamedSharding,  # noqa: E402
                                           RankShards, gather_shards,
                                           make_rules, mesh_coords,
                                           shard_of, spec_axes)
from repro_torch.runtime import make_train_step  # noqa: E402

GRANITE, KIMI = "granite_moe_1b_a400m", "kimi_k2_1t_a32b"
B, S = 4, 32
CF_NO_DROP = 4.0
TRAIN = dict(global_batch=B, seq_len=S, lr=1e-3, warmup_steps=1,
             total_steps=10)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_REL_L2 = 1e-4
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread_a_rank():
    """CPU ranks run from their own threads: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape, device="cpu"):
    return make_mesh(shape, AXES[len(shape)], [device] * int(np.prod(shape)))


def _cfg(arch, cf=CF_NO_DROP, **moe):
    cfg = registry.get_config(arch, smoke=True)
    return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf, **moe))


def _batch(cfg, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1]),
            "labels": torch.from_numpy(toks[:, 1:])}


def _pair(cfg, shape, par):
    """(the model on a mesh of ``shape`` of CPU ranks, its one-device copy
    of the same tree, the mesh), float32."""
    mesh = _mesh(shape)
    model = cast_tree(build_model(cfg, par, device="cpu", mesh=mesh),
                      torch.float32)
    return model, replicate(model, "cpu", one_device=True), mesh


@pytest.fixture(scope="module")
def cs():
    """``chip_smoke.py`` as a module (its card-free helpers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mesh_aux(cs, mesh):
    """One device's MoE layers with the mesh program's aux (the ranks'
    mean), outputs as one device."""
    dp = mesh.shape.get("pod", 1) * mesh.shape["data"]
    return cs.mesh_aux(torch, P_lm, P_moe, dp, mesh.shape["model"])


def _opt(model, tcfg):
    opt = init_opt_state(dict(model.named_parameters()), tcfg)
    return opt._replace(step=torch.tensor(1, dtype=torch.int32))


def _steps(model, one, mesh, par, cs):
    """(tp metrics, one-device metrics, tp gradients gathered, one-device
    gradients) of one step each, the gradients before the update."""
    cfg, tcfg = model.cfg, TrainConfig(**TRAIN)
    batch = _batch(cfg)
    step = make_train_step(model, cfg, tcfg, par, mesh)
    _, grads = step.grads(batch)
    specs = model.param_specs()
    got = {n: gather_shards([g[n] for g in grads], specs[n], mesh)
           for n in specs}
    _, met = step(_opt(model, tcfg), batch)
    with _mesh_aux(cs, mesh):
        logits, aux = one.apply(batch["tokens"])
        assert float(aux.detach()) > 0  # the loss holds the aux on both
        loss1 = P_steps.model_loss(one, cfg, logits, batch["labels"]) + aux
        names = [n for n, _ in one.named_parameters()]
        want = dict(zip(names, torch.autograd.grad(
            loss1, list(one.parameters()))))
        _, met1 = make_train_step(one, cfg, tcfg, par)(_opt(one, tcfg),
                                                       batch)
    return met, met1, got, want


def _close(model, one, met, met1, got=None, want=None):
    np.testing.assert_allclose(float(met["loss"]), float(met1["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(met1["grad_norm"]), rtol=LOSS_RTOL)
    for name, w in (want or {}).items():
        err = float((got[name] - w).norm() / w.norm())
        assert err <= GRAD_REL_L2, (name, err)
    for (n, p), q in zip(model.named_parameters(), one.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   err_msg=n, **PARAM_TOL)


# ------------------------------------------------------------ train steps

STEP_CASES = {"granite": (GRANITE, (2, 4), "xla", False),
              "kimi-fsdp": (KIMI, (2, 4), "xla", True),
              "granite-ring": (GRANITE, (2, 2), "ring", False)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_matches_one_device(case, cs):
    arch, shape, sync, fsdp = STEP_CASES[case]
    par = ParallelConfig(remat="block", fsdp=fsdp, grad_sync=sync)
    model, one, mesh = _pair(_cfg(arch), shape, par)
    assert model.partitioned
    met, met1, got, want = _steps(model, one, mesh, par, cs)
    _close(model, one, met, met1, got, want)


def test_planted_local_return_fails_the_step_comparison(monkeypatch,
                                                         cs):
    par = ParallelConfig(remat="block")
    model, one, mesh = _pair(_cfg(GRANITE), (2, 4), par)
    real, calls = spmd.all_to_all, threading.local()

    def keeping(x, axis, split_axis, concat_axis, tiled=False):
        out = real(x, axis, split_axis, concat_axis, tiled)
        calls.n = getattr(calls, "n", 0) + 1
        # calls 1-2 send layer 0's rows and ids, call 3 returns its rows
        if calls.n == 3 and spmd.axis_index("model") == 1:
            return x
        return out

    monkeypatch.setattr(P_moe, "all_to_all", keeping)
    met, met1, got, want = _steps(model, one, mesh, par, cs)
    with pytest.raises(AssertionError):
        _close(model, one, met, met1, got, want)


@pytest.mark.parametrize("shape", [(2, 4), (2, 2)])
def test_route_log_finds_tokens_routed_apart(shape, cs):
    """``chip_smoke.py``'s routing record of a step (``route_log``,
    ``route_flips``): the ranks' top-k sets equal one device's token by
    token (each rank's tokens its rows and sequence shard), and ranks'
    records swapped must show up as tokens routed apart."""
    dp, tp = shape
    par = ParallelConfig(remat="block")
    model, one, mesh = _pair(_cfg(GRANITE), shape, par)
    cfg, tcfg = model.cfg, TrainConfig(**TRAIN)
    batch = _batch(cfg)
    with _mesh_aux(cs, mesh), cs.route_log(torch, P_moe) as r1:
        logits, aux = one.apply(batch["tokens"])
        torch.autograd.grad(
            P_steps.model_loss(one, cfg, logits, batch["labels"]) + aux,
            list(one.parameters()))
    step = make_train_step(model, cfg, tcfg, par, mesh)
    with cs.route_log(torch, P_moe) as rm:
        step(_opt(model, tcfg), batch)
    L = len(model.blocks)
    one_fwd, ranks = r1.forward[None], rm.forward
    assert list(r1.forward) == [None] and len(one_fwd) == L
    assert sorted(ranks) == [(d, m) for d in range(dp) for m in range(tp)]
    flips, gaps = cs.route_flips(torch, one_fwd, ranks, L, B, S, dp, tp)
    assert flips == [0] * L and all(g > 0 for g in gaps)
    a, b = (0, 0), (dp - 1, tp - 1)
    swapped = {**ranks, a: ranks[b], b: ranks[a]}
    flips, _ = cs.route_flips(torch, one_fwd, swapped, L, B, S, dp, tp)
    assert all(f > 0 for f in flips)
    # remat block: every router call recomputed once, alike
    for log in (r1, rm):
        assert len(log.recompute) == sum(map(len, log.forward.values()))
        assert cs.remat_flips(torch, log) == 0
    ids = rm.recompute[0]
    ids[0] = ids[1] if not torch.equal(ids[0], ids[1]) else ids[0].flip(0)
    assert cs.remat_flips(torch, rm) == 1        # one token routed apart


@pytest.mark.parametrize("sync", ["xla", "ring"])
def test_step_collectives_by_kind(sync, cs):
    """A TPStep's collectives by kind on (2, 4), equal to the derivation
    ``chip_smoke.py``'s *tp* phase holds the card's step to."""
    par = ParallelConfig(remat="block", grad_sync=sync)
    model, _, mesh = _pair(_cfg(GRANITE), (2, 4), par)
    tcfg = TrainConfig(**TRAIN)
    step = make_train_step(model, model.cfg, tcfg, par, mesh)
    spmd.TALLY.clear()
    step(_opt(model, tcfg), _batch(model.cfg))
    got = spmd.TALLY.by_kind()
    spmd.TALLY.clear()
    leaves = len(list(model.parameters()))
    replicated = sum("model" not in spec_axes(sp)
                     for sp in model.param_specs().values())
    assert replicated == 4 * len(model.blocks) + 1  # ln1, ln2, wk, wv; final
    assert got == cs.tp_family_counts(len(model.blocks), 1, 1, leaves,
                                      replicated, sync)


# ------------------------------------------------------------ prefill

REF_SCRIPT = r"""
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs import registry
from repro.models import build_model
from repro.models.params import cast_tree

tokens = np.load(sys.argv[1])
out = {}
mesh = make_mesh((2, 4), ("data", "model"))
with jax.threefry_partitionable(False):
    for arch in ("granite_moe_1b_a400m", "kimi_k2_1t_a32b"):
        cfg = registry.get_config(arch, smoke=True)
        cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
        lm = build_model(cfg, mesh=mesh)
        params = cast_tree(lm.init(jax.random.PRNGKey(0)), jnp.float32)
        logits, aux = jax.jit(lm.apply)(params, jnp.asarray(tokens))
        out[f"{arch}:logits"], out[f"{arch}:aux"] = (np.asarray(logits),
                                                     np.asarray(aux))
        for path, v in jax.tree_util.tree_leaves_with_path(params):
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            out[f"{arch}:p/{key}"] = np.asarray(v, np.float32)
np.savez(sys.argv[2], **out)
print("REFERENCE_DONE")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_moe")
    tokens = _batch(_cfg(GRANITE))["tokens"].numpy()
    np.save(d / "tokens.npy", tokens)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                        str(d / "tokens.npy"), str(d / "out.npz")], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_DONE" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]
    return tokens, dict(np.load(d / "out.npz"))


def _tree(ref: dict, arch: str) -> dict:
    tree: dict = {}
    for key, v in ref.items():
        if key.startswith(f"{arch}:p/"):
            node = tree
            path = key.split(":p/")[1].split("/")
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
    return tree


@pytest.mark.parametrize("arch", [GRANITE, KIMI])
def test_prefill_with_drops_matches_the_reference_mesh(reference, arch):
    tokens, ref = reference
    cfg, mesh = _cfg(arch, cf=1.0), _mesh((2, 4))
    model = cast_tree(params_from_reference(cfg, _tree(ref, arch), "cpu",
                                            mesh=mesh), torch.float32)
    assert model.partitioned
    one = replicate(model, "cpu", one_device=True)
    with torch.no_grad():
        logits, aux = model.apply(torch.from_numpy(tokens))
        logits1, _ = one.apply(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), ref[f"{arch}:logits"],
                               **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), ref[f"{arch}:aux"], **LOGIT_TOL)
    # one device drops other rows: the split decides which
    assert not np.allclose(logits1.numpy(), logits.numpy(), **LOGIT_TOL)


def test_moe_block_inside_ranks_equals_the_ep_path():
    cfg, mesh = _cfg(GRANITE, cf=1.0), _mesh((2, 4))
    rng = np.random.default_rng(3)
    d, E, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    p = {"router": rng.standard_normal((d, E)) * 0.3,
         "wi": rng.standard_normal((E, d, 2, f)) / np.sqrt(d),
         "wo": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    p = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    x = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
    want, aux_want = P_moe.moe_block(p, x, cfg, make_rules(), mesh)
    got, aux = spmd.shard_map(
        lambda pl, xl: P_moe.moe_block(pl, xl, cfg, make_rules(), mesh),
        mesh=mesh, in_specs=({"router": spmd.P(), "wi": spmd.P("model"),
                              "wo": spmd.P("model")},
                             spmd.P("data", "model")),
        out_specs=(spmd.P("data", "model"), spmd.P()))(p, x)
    assert torch.equal(got, want) and torch.equal(aux, aux_want)
    shared = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, shared_expert_d_ff=64))
    with pytest.raises(ValueError, match="shared expert"):
        spmd.shard_map(lambda pl, xl: P_moe.moe_block(pl, xl, shared),
                       mesh=mesh, in_specs=({"router": spmd.P(),
                                             "wi": spmd.P("model"),
                                             "wo": spmd.P("model")},
                                            spmd.P("data", "model")),
                       out_specs=(spmd.P("data", "model"), spmd.P()))(p, x)


@pytest.mark.parametrize("seq", [S, S - 2], ids=["sp", "replicated"])
def test_prefill_with_a_shared_expert_matches_one_device(seq, cs):
    cfg = _cfg(GRANITE, shared_expert_d_ff=64)
    model, one, mesh = _pair(cfg, (2, 4), ParallelConfig())
    assert model.partitioned
    assert model.blocks[0].moe["shared_wi"].shape == (128, 2, 64)
    tokens = _batch(cfg)["tokens"][:, :seq]
    with torch.no_grad(), _mesh_aux(cs, mesh):
        got, aux = model.apply(tokens)
        want, aux1 = one.apply(tokens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(aux1), rtol=1e-5)


# ------------------------------------------------------------ specs

@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
@pytest.mark.parametrize("arch", [GRANITE, KIMI])
def test_moe_specs_are_the_references(arch, fsdp):
    mesh = _mesh((2, 4), "meta")
    model = make_model(registry.get_config(arch), ParallelConfig(fsdp=fsdp),
                       device="meta", mesh=mesh)
    specs = model.param_specs()
    ref = r_moe_spec(r_registry.get_config(arch), layers=model.n_groups)
    rules = r_make_rules(fsdp=fsdp)

    class _Mesh:            # spec_for reads the mesh's axis sizes only
        shape = dict(mesh.shape)

    for name in ("router", "wi", "wo"):
        want = r_spec_for(ref[name].axes, rules, _Mesh)
        assert want[0] is None                  # the stacked layer axis
        got = specs[f"blocks.0.moe.{name}"]
        assert tuple(got) == tuple(want)[1:], (name, got, want)
    table = {False: {"router": (None, "model"), "wi": ("model",),
                     "wo": ("model",)},
             True: {"router": ("data", "model"), "wi": ("model", "data"),
                    "wo": ("model", "data")}}[fsdp]
    for name, want in table.items():
        assert tuple(specs[f"blocks.0.moe.{name}"]) == want
    assert model.partitioned


# ------------------------------------------------------------ lone rank

def test_lone_rank_has_the_real_ranks_shapes_and_counts():
    par = ParallelConfig(remat="block", fsdp=True)
    model, _, mesh = _pair(_cfg(KIMI), (2, 4), par)
    batch = _batch(model.cfg)
    ranks = model.tp_ranks()
    shapes = [None] * len(ranks)

    def run(b):
        r = spmd.rank_index()
        return _loss(ranks[r], b, shapes, r)

    spmd.TALLY.clear()
    spmd.shard_map(run, mesh=mesh, in_specs=({"tokens": spmd.P("data"),
                                              "labels": spmd.P("data")},),
                   out_specs=spmd.P())(batch)
    real = spmd.TALLY.by_kind()
    spmd.TALLY.clear()
    for c in ({"data": 0, "model": 0}, {"data": 1, "model": 3}):
        r = mesh_coords(mesh).index(c)
        lone = [None] * len(ranks)
        with spmd.lone_rank(mesh, c):
            _loss(ranks[r], {k: v[2 * c["data"]:2 * c["data"] + 2]
                             for k, v in batch.items()}, lone, r)
        assert lone[r] == shapes[r], (c, lone[r], shapes[r])
        assert spmd.TALLY.by_kind() == real
        spmd.TALLY.clear()
    assert real["all-to-all"] and real["all-gather"] and \
        real["reduce-scatter"] and real["all-reduce"]


def _loss(rank, b, out, r):
    logits, aux = rank.apply(b["tokens"])
    out[r] = (tuple(logits.shape), tuple(aux.shape))
    return P_steps.model_loss(rank, rank.cfg, logits, b["labels"]) + aux


# ------------------------------------------------------------ dry-run

def _expected_counts(layers: int, accum: int, chunks: int,
                     ce_chunks: int) -> dict:
    """granite's partitioned train step, by kind and axes.  Per
    microbatch: the sequence all-gathered over model before each layer's
    attention and after the last layer (L + 1), the embedding's and each
    attention ``wo``'s partial product reduce-scattered (L + 1), each with
    its transpose in the backward; per MoE layer and dispatch chunk the
    router gathered whole over model in the forward (its transpose a
    reduce-scatter) and again in the recompute, two token all_to_alls with
    their transposes and one of expert ids (none in the recompute); the
    aux loss's pmean over (data, model) a layer and its transpose; the
    loss's pmax and psum per chunk (the psum's transpose too); the
    gradients of the 4L + 1 leaves replicated over model (ln1, ln2, wk,
    wv; final_norm) summed over it, and the norm's one psum; the 9L + 2
    leaves summed over data and the loss's pmean."""
    a, L, c = accum, layers, chunks
    return {"all-gather over model": a * (2 * (L + 1) + 2 * L * c),
            "reduce-scatter over model": a * (2 * (L + 1) + L * c),
            "all-to-all over model": a * 5 * L * c,
            "all-reduce over data,model": a * 2 * L,
            "all-reduce over model": a * ce_chunks * 3 + 4 * L + 2,
            "all-reduce over data": 9 * L + 3}


def test_dryrun_record_of_a_partitioned_moe_train_cell():
    mesh = _mesh((2, 4), "meta")
    cell = P_steps.build_cell(GRANITE, "train_4k", mesh, depth_override=1)
    assert cell.partitioned and cell.accum == 2
    rec = dryrun.measure(cell)
    # a rank's tokens a microbatch: 256 / 2 / 2 rows of 4096 / 4
    chunks = 256 // 2 // 2 * 4096 // 4 // P_moe.DISPATCH_CHUNK
    assert dryrun.by_axes(rec.pop("recorded")) == \
        _expected_counts(1, cell.accum, chunks, 4096 // 1024)
    assert not rec["memory"]["temp_at_full_model_width"]
    params = dryrun.rank_share(cell)[0]["blocks"]["0"]["moe"]
    assert params["router"].shape == (1024, 8)
    assert params["wi"].shape == (8, 1024, 2, 512)
    assert params["wo"].shape == (8, 512, 1024)


# ------------------------------------------------------------ checkpoint

def test_checkpoint_saved_on_2x4_restores_onto_4x2(tmp_path):
    par = ParallelConfig()
    model, _, mesh = _pair(_cfg(GRANITE), (2, 4), par)
    cfg, tcfg = model.cfg, TrainConfig(**TRAIN)
    opt, _ = make_train_step(model, cfg, tcfg, par, mesh)(
        _opt(model, tcfg), _batch(cfg))
    params = dict(model.named_parameters())
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(1, (params, opt), {"step": 1})
    other = _mesh((4, 2))
    target = make_model(cfg, par, device="meta", mesh=other)
    specs = target.param_specs()
    shardings = {n: NamedSharding(other, spec) for n, spec in specs.items()}
    (got, _), extra = mgr.restore(1, (params, opt),
                                  shardings=(shardings, None))
    assert extra == {"step": 1}
    assert tuple(specs["blocks.0.moe.wi"]) == ("model",)
    for name, p in params.items():
        rs = got[name]
        assert isinstance(rs, RankShards) and len(rs.shards) == 8
        assert torch.equal(rs.full(), p.detach())
        for c, block in zip(mesh_coords(other), rs.shards):
            assert torch.equal(block, shard_of(p.detach(), specs[name],
                                               other, c)), name


# ------------------------------------------------------------ refusals

def test_mla_is_no_longer_refused():
    """minicpm3's MLA runs tensor-parallel (tests/test_torch_tp_mla.py)."""
    mesh = _mesh((2, 4), "meta")
    for smoke in (True, False):
        check_tp(registry.get_config("minicpm3_4b", smoke=smoke), mesh)


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "whisper_large_v3"])
def test_other_families_still_refused(arch):
    cfg = registry.get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.*left 6"):
        check_tp(cfg, _mesh((2, 4), "meta"))
    check_tp(_cfg(GRANITE), _mesh((2, 4), "meta"))
    check_tp(_cfg(KIMI), _mesh((2, 4), "meta"))
