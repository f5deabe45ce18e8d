"""The port's tensor parallelism for the SSM and hybrid families
(mamba2-130m and jamba-v0.1-52b) against one device and the JAX package.

Every case runs on CPU ranks (``make_mesh(..., ["cpu"] * n)``) at smoke
width, in float32 (weights cast on both sides).  Inputs are drawn with
numpy from a seed.

A rank's SSM mixer is ``ssm_block`` on its blocks of the heads (``wz``,
``wx``, ``wdt``, ``dt_bias``, ``A_log``, ``D``, ``conv_x``, ``norm`` and
``wo`` over ``model``) with ``wB``, ``wC`` and ``conv_BC`` whole, so every
rank computes the full B and C; the gated RMSNorm is per head, so the
mixer's one collective is the sum of its row-parallel ``wo`` product.

- **Train step.**  mamba2-smoke's ``make_train_step`` on (data 2, model 4)
  and with ``grad_sync="ring"`` on (2, 2); on (1, 3), where its 8 heads
  are padded to 9; jamba-smoke's with its own policy (``fsdp=True``,
  ``remat="full"``) on (2, 4) at a capacity factor that drops nothing
  (``CF_NO_DROP``), its aux the mesh program's (``chip_smoke.py``'s
  ``mesh_aux``).  Each against the one-device step on the same tree, one
  step at lr 1e-3 from step 1 of the warm-up: loss and gradient norm rtol
  1e-5, every parameter atol 5e-5 / rtol 1e-4, each gradient within 1e-4
  relative L2.  jamba's update is held to the one-device step per leaf in
  relative L2 (``chip_smoke.py``'s ``TP_UPDATE_REL_L2``, 1e-2; it reads
  1.6e-3 at worst), and its parameters elementwise at the tolerance above
  to one device's AdamW on the ranks' gathered gradients: its float32
  gradients through 7 scans part from one device's by up to 4e-5
  relative L2 (layer
  0's ``D`` and ``dt_bias``; the one-device port against the reference
  parts by 5.9e-5, ``tests/test_torch_train.py``), and AdamW's first step,
  with the gradient norm of 178 clipped to 1, turns that rounding in
  entries within about 1e-6 of 0 into moves up to 2e-4 apart (9 of
  2,032,552 entries off the tolerance against the one-device step).
- **Planted fault.**  One rank (model index 1) normalizes layer 0's gated
  RMSNorm over its whole block of the inner dimension instead of per
  head: the step comparison must fail.
- **Prefill**: ``LM.apply`` of both models on (2, 4) against the
  reference's ``LM.apply`` on a (2, 4) mesh of 8 host devices (atol /
  rtol 1e-4; the reference in a child python, as
  ``tests/test_torch_moe.py``'s ``EP_SCRIPT``), its ranks carried from the
  reference's tree by ``ranks_from_reference``, each SSM leaf its block.
- The port's SSM parameter specs against the reference's ``spec_for``
  with FSDP on and off, and the table they give.
- A mamba2 step's collectives by kind against ``chip_smoke.py``'s
  derivation (``tp_family_counts``), with ``xla`` and ``ring`` sync.
- Lone-rank counts against the real ranks' (jamba under FSDP).
- Dry-run: a depth-1 mamba2 ``train_4k`` record and a one-period jamba
  ``train_4k`` record on a (2, 4) meta mesh, partitioned, their
  collectives by kind and axes equal to counts derived from the layers
  and the leaves' shardings.  The jamba record runs loop-free
  (``flags.ROOFLINE_MODE``: the vectorized scan, one dispatch chunk and
  one cross-entropy chunk, accum 1): its eager record walks 32 scan
  chunks a layer and 8 microbatches on meta, minutes of a CPU.
- A mamba2 checkpoint saved on (2, 4) restored onto (4, 2), bit for bit.
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
from repro.models.ssm import ssm_spec as r_ssm_spec  # noqa: E402
from repro.parallel.sharding import make_rules as r_make_rules  # noqa: E402
from repro.parallel.sharding import spec_for as r_spec_for  # noqa: E402

from repro_torch import flags  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as P_steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm as P_lm  # noqa: E402
from repro_torch.models import moe as P_moe  # noqa: E402
from repro_torch.models import ssm as P_ssm  # noqa: E402
from repro_torch.models.convert import ranks_from_reference  # noqa: E402
from repro_torch.models.model import check_tp, make_model, replicate  # noqa: E402,E501
from repro_torch.models.params import cast_tree  # noqa: E402
from repro_torch.optim import adamw_update, init_opt_state  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.parallel.sharding import (NamedSharding,  # noqa: E402
                                           RankShards, gather_shards,
                                           mesh_coords, shard_of,
                                           spec_axes)
from repro_torch.runtime import make_train_step  # noqa: E402

MAMBA, JAMBA = "mamba2_130m", "jamba_v0_1_52b"
B, S = 4, 32
CF_NO_DROP = 4.0
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


def _cfg(arch, cf=CF_NO_DROP):
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


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


def _opt(model, tcfg):
    opt = init_opt_state(dict(model.named_parameters()), tcfg)
    return opt._replace(step=torch.tensor(1, dtype=torch.int32))


def _steps(model, one, mesh, par, cs):
    """(tp metrics, one-device metrics, tp gradients gathered, one-device
    gradients) of one step each, the gradients before the update; the
    one-device side's MoE layers (jamba's) take the mesh program's aux."""
    cfg, tcfg = model.cfg, TrainConfig(**TRAIN)
    batch = _batch(cfg)
    step = make_train_step(model, cfg, tcfg, par, mesh)
    _, grads = step.grads(batch)
    specs = model.param_specs()
    got = {n: gather_shards([g[n] for g in grads], specs[n], mesh)
           for n in specs}
    _, met = step(_opt(model, tcfg), batch)
    with cs.mesh_aux(torch, P_lm, P_moe, mesh.shape["data"],
                     mesh.shape["model"]):
        logits, aux = one.apply(batch["tokens"])
        loss1 = P_steps.model_loss(one, cfg, logits, batch["labels"]) + aux
        names = [n for n, _ in one.named_parameters()]
        want = dict(zip(names, torch.autograd.grad(
            loss1, list(one.parameters()))))
        _, met1 = make_train_step(one, cfg, tcfg, par)(_opt(one, tcfg),
                                                       batch)
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

STEP_CASES = {"mamba2": (MAMBA, (2, 4), "xla", False, "block"),
              "mamba2-ring": (MAMBA, (2, 2), "ring", False, "block"),
              "mamba2-padded": (MAMBA, (1, 3), "xla", False, "block"),
              "jamba-fsdp-remat-full": (JAMBA, (2, 4), "xla", True,
                                        "full")}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_matches_one_device(case, cs):
    arch, shape, sync, fsdp, remat = STEP_CASES[case]
    par = ParallelConfig(remat=remat, fsdp=fsdp, grad_sync=sync)
    model, one, mesh = _pair(_cfg(arch), shape, par)
    assert model.partitioned
    heads = model.blocks[0].ssm["wz"].shape[1]
    assert heads == (9 if shape == (1, 3) else 8)
    same = replicate(model, "cpu", one_device=True)
    init = [p.detach().clone() for p in model.parameters()]
    met, met1, got, want = _steps(model, one, mesh, par, cs)
    if arch == JAMBA:
        # the update against the true one-device step, per leaf in relative
        # L2 (TP_UPDATE_REL_L2, as the card's steps are held), which the
        # few entries near 0 that AdamW's first step amplifies stay within
        for (n, p), q, p0 in zip(model.named_parameters(), one.parameters(),
                                 init):
            err = float((p - q).norm() / (q - p0).norm())
            assert err <= cs.TP_UPDATE_REL_L2, (n, err)
        # and elementwise against one device's AdamW on the ranks' gradients
        tcfg = TrainConfig(**TRAIN)
        with torch.no_grad():
            _, met2 = adamw_update(dict(same.named_parameters()), got,
                                   _opt(same, tcfg), tcfg)
        np.testing.assert_allclose(float(met2["grad_norm"]),
                                   float(met["grad_norm"]), rtol=LOSS_RTOL)
        one = same
    _close(model, one, met, met1, got, want)


def test_planted_per_block_norm_fails_the_step_comparison(monkeypatch,
                                                          cs):
    par = ParallelConfig(remat="block")
    model, one, mesh = _pair(_cfg(MAMBA), (2, 4), par)
    real = P_ssm._gated_out
    targets = {id(r.blocks[0].ssm["norm"]) for r in model.tp_ranks()
               if r.coords["model"] == 1}
    hit = threading.Event()

    def per_block(p, y, xh, z, x_in):
        if id(p["norm"]) not in targets:
            return real(p, y, xh, z, x_in)
        hit.set()
        y = (y + xh.float() * p["D"][:, None]) * torch.nn.functional.silu(
            z.float())
        var = (y ** 2).mean((-2, -1), keepdim=True)     # the whole block
        y = (y * torch.rsqrt(var + 1e-6) * p["norm"]).to(x_in.dtype)
        wo = p["wo"]
        return y.flatten(-2) @ wo.reshape(-1, wo.shape[-1])

    monkeypatch.setattr(P_ssm, "_gated_out", per_block)
    met, met1, got, want = _steps(model, one, mesh, par, cs)
    assert hit.is_set()
    with pytest.raises(AssertionError):
        _close(model, one, met, met1, got, want)


@pytest.mark.parametrize("sync", ["xla", "ring"])
def test_step_collectives_by_kind(sync, cs):
    """A mamba2 TPStep's collectives by kind on (2, 4), equal to the
    derivation ``chip_smoke.py``'s *tp* phase holds the card's step to."""
    par = ParallelConfig(remat="block", grad_sync=sync)
    model, _, mesh = _pair(_cfg(MAMBA), (2, 4), par)
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
    assert replicated == 4 * L + 1      # ln1, wB, wC, conv_BC; final_norm
    assert got == cs.tp_family_counts(L, 0, 1, leaves, replicated, sync)


def test_build_and_step_are_no_longer_refused():
    mesh = _mesh((2, 4), "meta")
    for arch in (MAMBA, JAMBA):
        for smoke in (True, False):
            check_tp(registry.get_config(arch, smoke=smoke), mesh)
        model = make_model(registry.get_config(arch), device="meta",
                           mesh=mesh)
        assert model.partitioned and P_lm.tp_ported(model.cfg)


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
    for arch in ("mamba2_130m", "jamba_v0_1_52b"):
        cfg = registry.get_config(arch, smoke=True)
        cfg = dataclasses.replace(cfg, dtype="float32")
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
    d = tmp_path_factory.mktemp("tp_ssm")
    tokens = _batch(_cfg(MAMBA))["tokens"].numpy()
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


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_prefill_matches_the_reference_mesh(reference, arch):
    tokens, ref = reference
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              dtype="float32")
    mesh = _mesh((2, 4))
    model, ranks = ranks_from_reference(cfg, _tree(ref, arch), mesh)
    model = cast_tree(model, torch.float32)
    assert model.partitioned
    specs = model.param_specs()
    ssm = [n for n in specs if ".ssm." in n]
    assert len(ssm) == 12 * sum(model.layer_kind(i) == "ssm"
                                for i in range(cfg.num_layers))
    for rank in ranks:
        held = dict(rank.named_parameters())
        for n in ssm:
            want = shard_of(dict(model.named_parameters())[n].detach(),
                            specs[n], mesh, rank.coords)
            assert torch.equal(held[n].detach().float(), want), n
    with torch.no_grad():
        logits, aux = model.apply(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), ref[f"{arch}:logits"],
                               **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), ref[f"{arch}:aux"], **LOGIT_TOL)


# ------------------------------------------------------------ specs

SSM_TABLE = {
    False: {"wz": (None, "model", None), "wx": (None, "model", None),
            "wB": (None, None), "wC": (None, None), "wdt": (None, "model"),
            "dt_bias": ("model",), "A_log": ("model",), "D": ("model",),
            "conv_x": (None, "model", None), "conv_BC": (None, None),
            "norm": ("model", None), "wo": ("model", None, None)},
    True: {"wz": ("data", "model", None), "wx": ("data", "model", None),
           "wB": ("data", None), "wC": ("data", None),
           "wdt": ("data", "model"), "dt_bias": ("model",),
           "A_log": ("model",), "D": ("model",),
           "conv_x": (None, "model", None), "conv_BC": (None, None),
           "norm": ("model", None), "wo": ("model", None, "data")}}


@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_ssm_specs_are_the_references(arch, fsdp):
    mesh = _mesh((2, 4), "meta")
    model = make_model(registry.get_config(arch), ParallelConfig(fsdp=fsdp),
                       device="meta", mesh=mesh)
    specs = model.param_specs()
    ref = r_ssm_spec(r_registry.get_config(arch), 4, layers=model.n_groups)
    rules = r_make_rules(fsdp=fsdp)

    class _Mesh:            # spec_for reads the mesh's axis sizes only
        shape = dict(mesh.shape)

    def full(spec, n):          # trailing None parts left out
        return tuple(spec) + (None,) * (n - len(tuple(spec)))

    for name, want in SSM_TABLE[fsdp].items():
        n = len(ref[name].shape)
        ref_spec = full(r_spec_for(ref[name].axes, rules, _Mesh), n)
        assert ref_spec[0] is None                # the stacked layer axis
        got = full(specs[f"blocks.0.ssm.{name}"], n - 1)
        assert got == ref_spec[1:] == want, (name, got, ref_spec)
    assert model.partitioned


# ------------------------------------------------------------ lone rank

def test_lone_rank_has_the_real_ranks_shapes_and_counts():
    par = ParallelConfig(remat="full", fsdp=True)
    model, _, mesh = _pair(_cfg(JAMBA), (2, 4), par)
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

def _expected_counts(model, accum: int, chunks: int, ce_chunks: int
                     ) -> dict:
    """A partitioned train step of an SSM or hybrid model with remat, by
    kind and axes.  Per microbatch: the sequence all-gathered over model
    before each mixer's and each MLP's segment and after the last layer,
    the embedding's and those segments' partial products reduce-scattered,
    each with its transpose in the backward (an SSM mixer is one such
    segment, as attention is); per MoE layer and dispatch chunk the router
    gathered whole over (data, model) in the forward and again in the
    recompute (its transpose a reduce-scatter), two token all_to_alls with
    their transposes and one of expert ids, and under FSDP its experts'
    ``wi`` and ``wo`` gathered over data likewise; the aux loss's pmean
    over (data, model) a MoE layer with its transpose; the loss's pmax and
    psum a cross-entropy chunk (the psum's transpose too); under FSDP the
    other leaves sharded over data gathered in the forward and again in
    the recompute, each recompute gather's transpose and the embedding's
    two a reduce-scatter.  Once a step: the gradients of the leaves
    replicated over model (ln1, ln2, the SSM's ``wB``, ``wC``,
    ``conv_BC``, ``wk``, ``wv``, final_norm) summed over it, those not
    sharded over data summed over data with the loss's pmean, and the
    gradient norm's psum over each group of axes the leaves are sharded
    on."""
    a, c = accum, chunks
    specs = model.param_specs()
    axes = {n: set(spec_axes(s)) for n, s in specs.items()}
    moe = sum(1 for b in model.blocks if "moe" in b._modules)
    mlp = sum(1 for b in model.blocks if "mlp" in b._modules)
    segments = len(model.blocks) + mlp
    experts = {n for n in specs if n.endswith((".moe.wi", ".moe.wo"))}
    fsdp = {n for n, ax in axes.items() if "data" in ax and
            not n.endswith(".moe.router")} - experts
    groups = {frozenset(ax) for ax in axes.values() if ax}
    out = {"all-gather over model": a * 2 * (segments + 1),
           "reduce-scatter over model": a * 2 * (segments + 1),
           "all-reduce over model": a * 3 * ce_chunks + sum(
               "model" not in ax for ax in axes.values()),
           "all-reduce over data": sum(
               "data" not in ax for ax in axes.values()) + 1}
    if moe:
        out["all-to-all over model"] = a * 5 * moe * c
        out["all-gather over data,model"] = a * 2 * moe * c
        out["reduce-scatter over data,model"] = a * moe * c
        out["all-reduce over data,model"] = a * 2 * moe
    for g in groups:
        key = "all-reduce over " + ",".join(
            x for x in ("data", "model") if x in g)
        out[key] = out.get(key, 0) + 1
    if fsdp:
        out["all-gather over data"] = a * (2 * len(fsdp) +
                                           4 * moe * c)
        out["reduce-scatter over data"] = a * (len(fsdp) + 1 +
                                               2 * moe * c)
    return out


def test_dryrun_record_of_a_partitioned_mamba2_train_cell():
    mesh = _mesh((2, 4), "meta")
    cell = P_steps.build_cell(MAMBA, "train_4k", mesh, depth_override=1)
    assert cell.partitioned and cell.accum == 1
    rec = dryrun.measure(cell)
    assert dryrun.by_axes(rec.pop("recorded")) == \
        _expected_counts(cell.model, 1, 1, 4096 // 1024)
    assert not rec["memory"]["temp_at_full_model_width"]
    params = dryrun.rank_share(cell)[0]["blocks"]["0"]["ssm"]
    assert params["wz"].shape == (768, 6, 64)       # 24 heads / 4
    assert params["wB"].shape == (768, 128)         # whole
    assert params["norm"].shape == (6, 64)


def test_dryrun_record_of_a_partitioned_jamba_train_cell():
    mesh = _mesh((2, 4), "meta")
    flags.set_roofline(True)
    try:
        cell = P_steps.build_cell(JAMBA, "train_4k", mesh, depth_override=8,
                                  policy_overrides={"accum": 1})
        assert cell.partitioned and cell.model.par.fsdp
        rec = dryrun.measure(cell)
    finally:
        flags.set_roofline(False)
    assert dryrun.by_axes(rec.pop("recorded")) == \
        _expected_counts(cell.model, 1, 1, 1)
    assert not rec["memory"]["temp_at_full_model_width"]
    params = dryrun.rank_share(cell)[0]["blocks"]
    assert params["0"]["ssm"]["wz"].shape == (2048, 32, 64)  # 128 / 4
    assert params["0"]["ssm"]["conv_BC"].shape == (4, 32)     # whole
    assert params["7"]["attn"]["wq"].shape == (2048, 8, 128)
    assert params["1"]["moe"]["wi"].shape == (4, 2048, 2, 14336)


# ------------------------------------------------------------ checkpoint

def test_checkpoint_saved_on_2x4_restores_onto_4x2(tmp_path):
    par = ParallelConfig()
    model, _, mesh = _pair(_cfg(MAMBA), (2, 4), par)
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
    assert tuple(specs["blocks.0.ssm.wz"]) == (None, "model")
    for name, p in params.items():
        rs = got[name]
        assert isinstance(rs, RankShards) and len(rs.shards) == 8
        assert torch.equal(rs.full(), p.detach())
        for c, block in zip(mesh_coords(other), rs.shards):
            assert torch.equal(block, shard_of(p.detach(), specs[name],
                                               other, c)), name
