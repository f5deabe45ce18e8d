"""The port's tensor parallelism for the MLA family (minicpm3-4b) against
one device and the JAX package.

Every case runs on CPU ranks (``make_mesh(..., ["cpu"] * n)``) at smoke
width, in float32 (weights cast on both sides).  Inputs are drawn with
numpy from a seed.

The reference's rules put ``q_lora`` over ``model``: a rank holds its
block of ``wq_a``'s columns and of ``wq_b``'s rows (every head of it),
its heads' blocks of ``wk_b``, ``wv_b`` and ``wo``, and ``wkv_a``,
``kv_norm`` and ``q_norm`` whole.  A rank's attention sublayer psums the
q latent's sum of squares over ``model`` (the q RMSNorm's mean is over
the whole ``q_lora_rank``), reduce-scatters its partial q over ``model``
along the heads, and sums its partial ``wo`` product over ``model``.

- **Train step.**  minicpm3-smoke's ``make_train_step`` on (data 2, model
  4) with ``grad_sync="xla"``, on (2, 2) with ``"ring"``, on (2, 4) with
  ``fsdp=True`` and ``remat="full"``, and on (1, 8), where its 4 heads are
  padded to 8.  Each against the one-device step on the same tree, one
  step at lr 1e-3 from step 1 of the warm-up: loss and gradient norm rtol
  1e-5, every parameter atol 5e-5 / rtol 1e-4, each gradient within 1e-4
  relative L2 (``tests/test_torch_tp_ssm.py``'s tolerances).
- **Planted fault.**  The ranks of model index 1 normalize their block of
  the q latent over the block alone (no psum of its sum of squares): the
  step comparison must fail.
- **Prefill**: ``LM.apply`` on (2, 4) against the reference's
  ``LM.apply`` on a (2, 4) mesh of 8 host devices (atol / rtol 1e-4; the
  reference in a child python, as ``tests/test_torch_tp_ssm.py`` runs
  it), its ranks carried from the reference's tree by
  ``ranks_from_reference``, each MLA leaf its block.
- The port's MLA parameter specs against the reference's ``spec_for``
  with FSDP on and off, and the table they give.
- A step's collectives by kind against ``chip_smoke.py``'s derivation
  (``tp_family_counts``), with ``xla`` and ``ring`` sync.
- Lone-rank counts and shapes against the real ranks' (under FSDP).
- Dry-run: a depth-1 minicpm3 ``train_4k`` record on a (2, 4) meta mesh,
  partitioned, its collectives by kind and axes equal to counts derived
  from the layers and the leaves' shardings.
- A checkpoint saved on (2, 4) restored onto (4, 2), bit for bit.
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
from repro.models.mla import mla_spec as r_mla_spec  # noqa: E402
from repro.parallel.sharding import make_rules as r_make_rules  # noqa: E402
from repro.parallel.sharding import spec_for as r_spec_for  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as P_steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm as P_lm  # noqa: E402
from repro_torch.models import mla as P_mla  # noqa: E402
from repro_torch.models.convert import ranks_from_reference  # noqa: E402
from repro_torch.models.model import check_tp, make_model, replicate  # noqa: E402,E501
from repro_torch.models.params import cast_tree  # noqa: E402
from repro_torch.optim import init_opt_state  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.parallel.sharding import (NamedSharding,  # noqa: E402
                                           RankShards, gather_shards,
                                           mesh_coords, shard_of,
                                           spec_axes)
from repro_torch.runtime import make_train_step  # noqa: E402

ARCH = "minicpm3_4b"
B, S = 4, 32
TRAIN = dict(global_batch=B, seq_len=S, lr=1e-3, warmup_steps=1,
             total_steps=10)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_REL_L2 = 1e-4
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread_a_rank():
    """CPU ranks run from their own threads: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape, device="cpu"):
    return make_mesh(shape, ("data", "model"),
                     [device] * int(np.prod(shape)))


def _cfg():
    return dataclasses.replace(registry.get_config(ARCH, smoke=True),
                               dtype="float32")


def _batch(cfg, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1]),
            "labels": torch.from_numpy(toks[:, 1:])}


def _pair(shape, par):
    """(minicpm3-smoke on a mesh of ``shape`` of CPU ranks, its one-device
    copy of the same tree, the mesh), float32."""
    mesh = _mesh(shape)
    model = cast_tree(build_model(_cfg(), par, device="cpu", mesh=mesh),
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


def _opt(model, tcfg):
    opt = init_opt_state(dict(model.named_parameters()), tcfg)
    return opt._replace(step=torch.tensor(1, dtype=torch.int32))


def _steps(model, one, mesh, par):
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
    logits, aux = one.apply(batch["tokens"])
    loss1 = P_steps.model_loss(one, cfg, logits, batch["labels"]) + aux
    names = [n for n, _ in one.named_parameters()]
    want = dict(zip(names, torch.autograd.grad(loss1,
                                               list(one.parameters()))))
    _, met1 = make_train_step(one, cfg, tcfg, par)(_opt(one, tcfg), batch)
    return met, met1, got, want


def _close(model, one, met, met1, got, want):
    np.testing.assert_allclose(float(met["loss"]), float(met1["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(met1["grad_norm"]), rtol=LOSS_RTOL)
    for name, w in want.items():
        err = float((got[name] - w).norm() / w.norm())
        assert err <= GRAD_REL_L2, (name, err)
    for (n, p), q in zip(model.named_parameters(), one.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   err_msg=n, **PARAM_TOL)


# ------------------------------------------------------------ train steps

STEP_CASES = {"xla": ((2, 4), "xla", False, "block"),
              "ring": ((2, 2), "ring", False, "block"),
              "fsdp-remat-full": ((2, 4), "xla", True, "full"),
              "padded-heads": ((1, 8), "xla", False, "block")}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_matches_one_device(case):
    shape, sync, fsdp, remat = STEP_CASES[case]
    par = ParallelConfig(remat=remat, fsdp=fsdp, grad_sync=sync)
    model, one, mesh = _pair(shape, par)
    assert model.partitioned
    wq_b = model.blocks[0].attn["wq_b"]
    assert wq_b.shape[1] == (8 if shape == (1, 8) else 4)     # heads
    rank = model.tp_ranks()[0].blocks[0].attn
    assert rank["wq_a"].shape[1] == 64 // shape[1]           # q_lora block
    assert rank["wq_b"].shape[:2] == (64 // shape[1], wq_b.shape[1])
    assert rank["wkv_a"].shape[1] == 32 + 16                 # whole
    _close(model, one, *_steps(model, one, mesh, par))


def test_planted_per_block_q_norm_fails_the_step_comparison(monkeypatch):
    par = ParallelConfig(remat="block")
    model, one, mesh = _pair((2, 4), par)
    real = P_lm.mla_q_tp_b
    hit = threading.Event()

    def per_block(p, ql, sq, cfg, rank):
        if rank != 1:
            return real(p, ql, sq, cfg, rank)
        hit.set()
        n = ql.shape[-1]
        qf = ql.float()                 # the block's own mean, no psum
        y = qf * torch.rsqrt(qf.pow(2).mean(-1, keepdim=True) +
                             P_mla.RMS_EPS) * p["q_norm"][n:2 * n]
        return P_mla._proj(y.to(ql.dtype), p["wq_b"])

    monkeypatch.setattr(P_lm, "mla_q_tp_b", per_block)
    met, met1, got, want = _steps(model, one, mesh, par)
    assert hit.is_set()
    with pytest.raises(AssertionError):
        _close(model, one, met, met1, got, want)


@pytest.mark.parametrize("sync", ["xla", "ring"])
def test_step_collectives_by_kind(sync, cs):
    """A minicpm3 TPStep's collectives by kind on (2, 4), equal to the
    derivation ``chip_smoke.py``'s *tp* phase holds the card's step to."""
    par = ParallelConfig(remat="block", grad_sync=sync)
    model, _, mesh = _pair((2, 4), par)
    tcfg = TrainConfig(**TRAIN)
    step = make_train_step(model, model.cfg, tcfg, par, mesh)
    spmd.TALLY.clear()
    step(_opt(model, tcfg), _batch(model.cfg))
    got = spmd.TALLY.by_kind()
    spmd.TALLY.clear()
    leaves = len(list(model.parameters()))
    replicated = sum("model" not in spec_axes(sp)
                     for sp in model.param_specs().values())
    L = len(model.blocks)
    # ln1, q_norm, wkv_a, kv_norm, ln2 a layer; final_norm
    assert replicated == 5 * L + 1
    assert got == cs.tp_family_counts(L, 0, 1, leaves, replicated, sync,
                                      mlps=L, mla=L)


def test_build_and_step_are_no_longer_refused():
    mesh = _mesh((2, 4), "meta")
    for smoke in (True, False):
        check_tp(registry.get_config(ARCH, smoke=smoke), mesh)
    model = make_model(registry.get_config(ARCH), device="meta", mesh=mesh)
    assert model.partitioned and P_lm.tp_ported(model.cfg)
    for arch in ("qwen2_vl_2b", "whisper_large_v3"):
        with pytest.raises(NotImplementedError, match="ROADMAP.*left 6"):
            check_tp(registry.get_config(arch, smoke=True), mesh)


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
    cfg = registry.get_config("minicpm3_4b", smoke=True)
    cfg = dataclasses.replace(cfg, dtype="float32")
    lm = build_model(cfg, mesh=mesh)
    params = cast_tree(lm.init(jax.random.PRNGKey(0)), jnp.float32)
    logits, aux = jax.jit(lm.apply)(params, jnp.asarray(tokens))
    out["logits"], out["aux"] = np.asarray(logits), np.asarray(aux)
    for path, v in jax.tree_util.tree_leaves_with_path(params):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[f"p/{key}"] = np.asarray(v, np.float32)
np.savez(sys.argv[2], **out)
print("REFERENCE_DONE")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_mla")
    tokens = _batch(_cfg())["tokens"].numpy()
    np.save(d / "tokens.npy", tokens)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                        str(d / "tokens.npy"), str(d / "out.npz")], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_DONE" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]
    return tokens, dict(np.load(d / "out.npz"))


def _tree(ref: dict) -> dict:
    tree: dict = {}
    for key, v in ref.items():
        if key.startswith("p/"):
            node = tree
            path = key[2:].split("/")
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
    return tree


def test_prefill_matches_the_reference_mesh(reference):
    tokens, ref = reference
    mesh = _mesh((2, 4))
    model, ranks = ranks_from_reference(_cfg(), _tree(ref), mesh)
    model = cast_tree(model, torch.float32)
    assert model.partitioned
    specs = model.param_specs()
    mla = [n for n in specs if ".attn." in n]
    assert len(mla) == 8 * model.cfg.num_layers
    for rank in ranks:
        held = dict(rank.named_parameters())
        for n in mla:
            want = shard_of(dict(model.named_parameters())[n].detach(),
                            specs[n], mesh, rank.coords)
            assert torch.equal(held[n].detach().float(), want), n
    with torch.no_grad():
        logits, aux = model.apply(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), ref["aux"], **LOGIT_TOL)


# ------------------------------------------------------------ specs

MLA_TABLE = {
    False: {"wq_a": (None, "model"), "q_norm": (None,),
            "wq_b": ("model", None, None), "wkv_a": (None, None),
            "kv_norm": (None,), "wk_b": (None, "model", None),
            "wv_b": (None, "model", None), "wo": ("model", None, None)},
    True: {"wq_a": ("data", "model"), "q_norm": (None,),
           "wq_b": ("model", None, None), "wkv_a": ("data", None),
           "kv_norm": (None,), "wk_b": (None, "model", None),
           "wv_b": (None, "model", None), "wo": ("model", None, "data")}}


@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
def test_mla_specs_are_the_references(fsdp):
    mesh = _mesh((2, 4), "meta")
    model = make_model(registry.get_config(ARCH), ParallelConfig(fsdp=fsdp),
                       device="meta", mesh=mesh)
    specs = model.param_specs()
    ref = r_mla_spec(r_registry.get_config(ARCH), 4, layers=model.n_groups)
    rules = r_make_rules(fsdp=fsdp)

    class _Mesh:            # spec_for reads the mesh's axis sizes only
        shape = dict(mesh.shape)

    def full(spec, n):          # trailing None parts left out
        return tuple(spec) + (None,) * (n - len(tuple(spec)))

    for name, want in MLA_TABLE[fsdp].items():
        n = len(ref[name].shape)
        ref_spec = full(r_spec_for(ref[name].axes, rules, _Mesh), n)
        assert ref_spec[0] is None                # the stacked layer axis
        got = full(specs[f"blocks.0.attn.{name}"], n - 1)
        assert got == ref_spec[1:] == want, (name, got, ref_spec)
    assert model.partitioned


# ------------------------------------------------------------ lone rank

def _loss(rank, b, out, r):
    logits, aux = rank.apply(b["tokens"])
    out[r] = (tuple(logits.shape), tuple(aux.shape))
    return P_steps.model_loss(rank, rank.cfg, logits, b["labels"]) + aux


def test_lone_rank_has_the_real_ranks_shapes_and_counts():
    par = ParallelConfig(remat="full", fsdp=True)
    model, _, mesh = _pair((2, 4), par)
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
    assert real["all-gather"] and real["reduce-scatter"] and \
        real["all-reduce"]


# ------------------------------------------------------------ dry-run

def _expected_counts(model, accum: int, ce_chunks: int) -> dict:
    """A partitioned train step of a dense MLA model with remat, without
    FSDP, by kind and axes.  Per microbatch: the sequence all-gathered over
    model before each layer's attention and MLP and after the last layer,
    the embedding's and those sublayers' partial products
    reduce-scattered, each with its transpose in the backward; per layer
    the q latent's sum of squares psummed and the partial q
    reduce-scattered over model, each with its transpose; the loss's pmax
    and psum a cross-entropy chunk (the psum's transpose too).  Once a
    step: the gradients of the leaves replicated over model (ln1, ln2,
    ``q_norm``, ``wkv_a``, ``kv_norm``, final_norm) summed over it, every
    leaf's over data with the loss's pmean, and the gradient norm's psum
    over each group of axes the leaves are sharded on."""
    a, L = accum, len(model.blocks)
    axes = {n: set(spec_axes(s)) for n, s in model.param_specs().items()}
    mlp = sum(1 for b in model.blocks if "mlp" in b._modules)
    out = {"all-gather over model": a * (2 * (L + mlp + 1) + L),
           "reduce-scatter over model": a * (2 * (L + mlp + 1) + L),
           "all-reduce over model": a * (3 * ce_chunks + 2 * L) + sum(
               "model" not in ax for ax in axes.values()),
           "all-reduce over data": sum(
               "data" not in ax for ax in axes.values()) + 1}
    for g in {frozenset(ax) for ax in axes.values() if ax}:
        key = "all-reduce over " + ",".join(
            x for x in ("data", "model") if x in g)
        out[key] = out.get(key, 0) + 1
    return out


def test_dryrun_record_of_a_partitioned_minicpm3_train_cell():
    mesh = _mesh((2, 4), "meta")
    cell = P_steps.build_cell(ARCH, "train_4k", mesh, depth_override=1)
    assert cell.partitioned and cell.accum == 2
    assert not cell.model.par.fsdp
    rec = dryrun.measure(cell)
    assert dryrun.by_axes(rec.pop("recorded")) == \
        _expected_counts(cell.model, 2, 4096 // 1024)
    assert not rec["memory"]["temp_at_full_model_width"]
    attn = dryrun.rank_share(cell)[0]["blocks"]["0"]["attn"]
    assert attn["wq_a"].shape == (2560, 192)        # q_lora 768 / 4
    assert attn["wq_b"].shape == (192, 40, 96)      # every head
    assert attn["wk_b"].shape == (256, 10, 64)      # 40 heads / 4
    assert attn["wkv_a"].shape == (2560, 288)       # whole


# ------------------------------------------------------------ checkpoint

def test_checkpoint_saved_on_2x4_restores_onto_4x2(tmp_path):
    par = ParallelConfig()
    model, _, mesh = _pair((2, 4), par)
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
    assert tuple(specs["blocks.0.attn.wq_b"]) == ("model",)
    for name, p in params.items():
        rs = got[name]
        assert isinstance(rs, RankShards) and len(rs.shards) == 8
        assert torch.equal(rs.full(), p.detach())
        for c, block in zip(mesh_coords(other), rs.shards):
            assert torch.equal(block, shard_of(p.detach(), specs[name],
                                               other, c)), name
