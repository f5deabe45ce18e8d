"""The port's tensor parallelism for the dense GQA family against one
device and the JAX package.

Every case runs on CPU ranks (``make_mesh(..., ["cpu"] * n)``) at smoke
width, in float32 (weights cast on both sides).  Inputs are drawn with
numpy from a seed.

- **Train step.**  danube-smoke's ``make_train_step`` on (data 2, model 4)
  (4 heads at tp 4, vocabulary 512 = 4 x 128: padding is a no-op) against
  the port's one-device step and the reference's, one step at lr 1e-3 from
  step 1 of the warm-up (AdamW moves a weight by about lr times the sign
  of its gradient, so a gradient within rounding of 0 may move it by up
  to lr, as in ``tests/test_torch_train.py``): loss rtol 1e-5, gradient
  norm rtol 1e-5, every parameter atol 5e-5 / rtol 1e-4 (PARAM_TOL), and
  each gradient against one device's at rtol 1e-4 / atol 1e-6.
  nemotron340-smoke (6 heads padded to 8, untied unembedding, squared
  ReLU) with ``fsdp=True`` on (2, 4) against the one-device step on the
  same padded tree; ``grad_sync="ring"`` on (data 2, model 2) and
  ``"hierarchical"`` on (pod 2, data 2, model 2) likewise.  Every
  replicated leaf's synced gradient is bit-equal on every rank.
- **Planted fault.**  One rank (model index 1) keeps its own partial
  product instead of the reduce-scatter after layer 0's ``wo``: the step
  comparison must fail.
- **Prefill.**  ``LM.apply`` on (data 1, model 4) against one device and
  the reference's ``apply`` (logits rtol 1e-4 / atol 1e-4).
- **Vocabulary-parallel cross entropy** with padded columns on the last
  rank, unchunked and chunked, and its gradient, against the plain one
  (rtol 1e-5).
- **Checkpoint** saved from (2, 4) and restored onto (4, 2): every rank's
  block equal to the global array's block, bit for bit.
- **Lone-rank mode**: one rank's forward alone has the real ranks' shapes
  and collective counts.
- **Dry-run**: danube's ``train_4k`` cell on a (2, 4) mesh of meta devices
  at depth 1: partitioned, and its recorded collectives by kind and axes
  equal to the counts derived from the layer count below
  (``_expected_counts``).
- ``fits_h100`` holds a record against the card's reported 85,017,493,504
  bytes (a 79.5 GiB record does not fit), and the switch pipeline has its
  ``ops`` entry.
"""
import dataclasses
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.config import ParallelConfig as RParallelConfig  # noqa: E402
from repro.config import TrainConfig as RTrainConfig  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.models.params import cast_tree as r_cast_tree  # noqa: E402
from repro.optim.adamw import OptState as ROptState  # noqa: E402
from repro.runtime.train import make_train_step as r_make_train_step  # noqa: E402,E501

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as P_steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402,E501
from repro_torch.models.convert import (params_to_reference,  # noqa: E402
                                        ranks_from_reference)
from repro_torch.models.model import make_model, replicate  # noqa: E402
from repro_torch.models.params import cast_tree  # noqa: E402
from repro_torch.optim import init_opt_state  # noqa: E402
from repro_torch.parallel import spmd  # noqa: E402
from repro_torch.parallel.sharding import (NamedSharding,  # noqa: E402
                                           RankShards, mesh_coords,
                                           shard_of)
from repro_torch.runtime import make_train_step  # noqa: E402

DANUBE, NEMOTRON = "h2o_danube_3_4b", "nemotron_4_340b"
B, S = 4, 32
TRAIN = dict(global_batch=B, seq_len=S, lr=1e-3, warmup_steps=1,
             total_steps=10)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_a_rank():
    """CPU ranks run from their own threads: one intra-op thread each (an
    OpenMP team a rank thread oversubscribes the cores many times)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _mesh(shape):
    n = int(np.prod(shape))
    return make_mesh(shape, AXES[len(shape)], ["cpu"] * n)


def _cfg(arch):
    return dataclasses.replace(registry.get_config(arch, smoke=True),
                               dtype="float32")


def _batch(cfg, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return toks, {"tokens": torch.from_numpy(toks[:, :-1]),
                  "labels": torch.from_numpy(toks[:, 1:])}


@functools.lru_cache(maxsize=None)
def _reference():
    """(initial float32 tree, loss, grad norm, final float32 tree) of one
    reference step on danube-smoke at step 1 of the warm-up."""
    cfg = _cfg(DANUBE)
    toks, _ = _batch(cfg)
    with jax.threefry_partitionable(False):
        rcfg = dataclasses.replace(r_registry.get_config(DANUBE, smoke=True),
                                   dtype="float32")
        model = r_build_model(rcfg)
        params = r_cast_tree(model.init(jax.random.PRNGKey(0)), jnp.float32)
        init = jax.tree.map(_np, params)
        tcfg = RTrainConfig(**TRAIN)
        opt = ROptState(step=jnp.int32(1),
                        m=jax.tree.map(jnp.zeros_like, params),
                        v=jax.tree.map(jnp.zeros_like, params),
                        master=jax.tree.map(lambda x: jnp.array(x, copy=True),
                                            params))
        step = r_make_train_step(model, rcfg, tcfg, RParallelConfig(), None)
        p2, _, met = step(params, opt, {"tokens": jnp.asarray(toks[:, :-1]),
                                        "labels": jnp.asarray(toks[:, 1:])})
        logits, _ = model.apply(jax.tree.map(jnp.asarray, init),
                                jnp.asarray(toks[:, :-1]))
        return (init, float(met["loss"]), float(met["grad_norm"]),
                jax.tree.map(_np, p2), _np(logits))


def _opt(model, tcfg):
    opt = init_opt_state(dict(model.named_parameters()), tcfg)
    return opt._replace(step=torch.tensor(1, dtype=torch.int32))


def _pair(arch, shape, par, tree=None):
    """(the model on a mesh of ``shape`` of CPU ranks, its one-device copy
    of the same padded tree), float32."""
    cfg, mesh = _cfg(arch), _mesh(shape)
    if tree is None:
        model = build_model(cfg, par, device="cpu", mesh=mesh)
    else:
        model = params_from_reference(cfg, tree, "cpu", par=par, mesh=mesh)
    cast_tree(model, torch.float32)
    return model, replicate(model, "cpu", one_device=True), mesh


def _steps(model, one, mesh, par):
    """One step of each: (tp metrics, one-device metrics)."""
    cfg, tcfg = model.cfg, TrainConfig(**TRAIN)
    _, batch = _batch(cfg)
    step = make_train_step(model, cfg, tcfg, par, mesh)
    _, met = step(_opt(model, tcfg), batch)
    _, met1 = make_train_step(one, cfg, tcfg, par)(_opt(one, tcfg), batch)
    return met, met1


def _close(model, one, met, met1):
    np.testing.assert_allclose(float(met["loss"]), float(met1["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(met1["grad_norm"]), rtol=LOSS_RTOL)
    for (n, p), q in zip(model.named_parameters(), one.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   err_msg=n, **PARAM_TOL)


# ------------------------------------------------------------ train steps

def test_danube_step_matches_one_device_and_reference():
    init, r_loss, r_norm, r_final, _ = _reference()
    par = ParallelConfig(remat="block")
    model, one, mesh = _pair(DANUBE, (2, 4), par, init)
    assert model.partitioned and model.vocab_padded == 512
    met, met1 = _steps(model, one, mesh, par)
    _close(model, one, met, met1)
    np.testing.assert_allclose(float(met["loss"]), r_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["grad_norm"]), r_norm,
                               rtol=LOSS_RTOL)
    got = params_to_reference(model)
    for path, want in jax.tree_util.tree_leaves_with_path(r_final):
        have = got
        for k in path:
            have = have[k.key]
        np.testing.assert_allclose(have, want, err_msg=str(path),
                                   **PARAM_TOL)


@pytest.mark.parametrize("arch,shape,sync,fsdp", [
    (NEMOTRON, (2, 4), "xla", True),
    (DANUBE, (2, 2), "ring", False),
    (DANUBE, (2, 2, 2), "hierarchical", True)],
    ids=["nemotron-fsdp", "ring", "hierarchical"])
def test_step_matches_one_device(arch, shape, sync, fsdp):
    par = ParallelConfig(remat="block", fsdp=fsdp, grad_sync=sync)
    model, one, mesh = _pair(arch, shape, par)
    if arch == NEMOTRON:
        assert model.blocks[0].attn["wq"].shape[1] == 8   # 6 heads padded
    met, met1 = _steps(model, one, mesh, par)
    _close(model, one, met, met1)


def test_synced_gradients_equal_one_device_and_replicas_agree():
    par = ParallelConfig(remat="none", fsdp=True)
    model, one, mesh = _pair(NEMOTRON, (2, 4), par)
    cfg, tcfg = model.cfg, TrainConfig(**TRAIN)
    _, batch = _batch(cfg)
    step = make_train_step(model, cfg, tcfg, par, mesh)
    loss, grads = step.grads(batch)
    loss1 = P_steps.cross_entropy(one.apply(batch["tokens"])[0][
        ..., :cfg.vocab_size], batch["labels"])
    want = dict(zip([n for n, _ in one.named_parameters()],
                    torch.autograd.grad(loss1, list(one.parameters()))))
    np.testing.assert_allclose(float(loss), float(loss1.detach()),
                               rtol=LOSS_RTOL)
    specs, ranks = model.param_specs(), step.ranks or model.tp_ranks()
    for name, g in want.items():
        blocks = [grads[r][name] for r in range(len(ranks))]
        for c, gr in zip(mesh_coords(mesh), blocks):
            np.testing.assert_allclose(
                gr.numpy(), shard_of(g, specs[name], mesh, c).numpy(),
                err_msg=name, **GRAD_TOL)
        # replicas of a block (ranks that hold the same block) bit-equal
        seen = {}
        for c, gr in zip(mesh_coords(mesh), blocks):
            key = tuple(c[a] for p in specs[name]
                        for a in ((p,) if isinstance(p, str) else p or ()))
            if key in seen:
                assert torch.equal(seen[key], gr), name
            seen.setdefault(key, gr)


def test_planted_missing_psum_fails_the_step_comparison(monkeypatch):
    par = ParallelConfig(remat="block")
    model, one, mesh = _pair(DANUBE, (2, 4), par)
    real, calls = spmd.psum_scatter, threading.local()

    def skipping(x, axis, dim=0):
        out = real(x, axis, dim)
        calls.n = getattr(calls, "n", 0) + 1
        # call 1 is the embedding's, call 2 layer 0's wo
        if calls.n == 2 and spmd.axis_index("model") == 1:
            n = x.shape[dim] // spmd.axis_size("model")
            return x.narrow(dim, n, n).contiguous()
        return out

    monkeypatch.setattr(spmd, "psum_scatter", skipping)
    met, met1 = _steps(model, one, mesh, par)
    with pytest.raises(AssertionError):
        _close(model, one, met, met1)


# ------------------------------------------------------------ prefill

def test_prefill_matches_one_device_and_reference():
    init, _, _, _, r_logits = _reference()
    model, one, _ = _pair(DANUBE, (1, 4), ParallelConfig(), init)
    _, batch = _batch(model.cfg)
    with torch.no_grad():
        got, _ = model.apply(batch["tokens"])
        want, _ = one.apply(batch["tokens"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(), r_logits, **LOGIT_TOL)


def test_ranks_from_reference_hold_their_blocks():
    init = _reference()[0]
    mesh = _mesh((2, 4))
    model, ranks = ranks_from_reference(_cfg(DANUBE), init, mesh)
    specs = model.param_specs()
    for c, rank in zip(mesh_coords(mesh), ranks):
        assert rank.coords == c
        for name, p in model.named_parameters():
            got = dict(rank.named_parameters())[name]
            assert torch.equal(got, shard_of(p.detach(), specs[name], mesh,
                                             c)), (c, name)


@pytest.mark.parametrize("seq", [24, 2048], ids=["whole", "chunked"])
def test_vocab_parallel_cross_entropy_masks_the_padding(seq):
    """vocabulary 27 over 4 ranks of 8 columns: the last rank's 5 padded
    columns hold large values that must not count."""
    rng = np.random.default_rng(seq)
    logits = torch.from_numpy(rng.standard_normal((2, seq, 32)).astype(
        np.float32) * 3)
    logits[..., 27:] = 50.0
    labels = torch.from_numpy(rng.integers(0, 27, (2, seq)))
    logits.requires_grad_()
    mesh = _mesh((1, 4))
    got = spmd.shard_map(
        lambda lg, lb: P_steps.cross_entropy_tp(lg, lb, 27), mesh=mesh,
        in_specs=(spmd.P(None, None, "model"), spmd.P()),
        out_specs=spmd.P())(logits, labels)
    (g_got,) = torch.autograd.grad(got, [logits])
    want = P_steps.cross_entropy(logits[..., :27], labels)
    (g_want,) = torch.autograd.grad(want, [logits])
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(g_got.numpy(), g_want.numpy(), rtol=1e-5,
                               atol=1e-9)


# ------------------------------------------------------------ checkpoint

def test_checkpoint_saved_on_2x4_restores_onto_4x2(tmp_path):
    par = ParallelConfig(fsdp=True)
    model, _, mesh = _pair(NEMOTRON, (2, 4), par)
    cfg, tcfg = model.cfg, TrainConfig(**TRAIN)
    opt, _ = make_train_step(model, cfg, tcfg, par, mesh)(
        _opt(model, tcfg), _batch(cfg)[1])
    params = dict(model.named_parameters())
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(1, (params, opt), {"step": 1})
    other = make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    target = make_model(cfg, par, device="meta", mesh=other)
    specs = target.param_specs()
    shardings = {n: NamedSharding(other, spec) for n, spec in specs.items()}
    (got, _), extra = mgr.restore(1, (params, opt),
                                  shardings=(shardings, None))
    assert extra == {"step": 1}
    for name, p in params.items():
        rs = got[name]
        assert isinstance(rs, RankShards) and len(rs.shards) == 8
        assert torch.equal(rs.full(), p.detach())
        for c, block in zip(mesh_coords(other), rs.shards):
            assert torch.equal(block, shard_of(p.detach(), specs[name],
                                               other, c)), name


# ------------------------------------------------------------ lone rank

def test_lone_rank_has_the_real_ranks_shapes_and_counts():
    par = ParallelConfig(remat="block", fsdp=True)
    model, _, mesh = _pair(NEMOTRON, (2, 4), par)
    _, batch = _batch(model.cfg)
    ranks = model.tp_ranks()
    shapes = [None] * len(ranks)

    def run(b):
        r = spmd.rank_index()
        return P_steps.model_loss(ranks[r], ranks[r].cfg,
                                  *_shape_of(ranks[r], b, shapes, r))

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
            P_steps.model_loss(ranks[r], ranks[r].cfg, *_shape_of(
                ranks[r], {k: v[2 * c["data"]:2 * c["data"] + 2]
                           for k, v in batch.items()}, lone, r))
        assert lone[r] == shapes[r], (c, lone[r], shapes[r])
        assert spmd.TALLY.by_kind() == real
        spmd.TALLY.clear()
    assert real["all-gather"] and real["reduce-scatter"] and \
        real["all-reduce"]


def _shape_of(rank, b, out, r):
    logits, _ = rank.apply(b["tokens"])
    out[r] = tuple(logits.shape)
    return logits, b["labels"]


# ------------------------------------------------------------ dry-run

def _expected_counts(layers: int, accum: int, chunks: int) -> dict:
    """danube's partitioned train step, by kind and axes: per microbatch
    the sequence is all-gathered over model before each of a layer's two
    sub-blocks and after the last (2L + 1), each sub-block's partial
    product and the embedding reduce-scattered (2L + 1), each with its
    transpose in the backward; the loss's pmax and psum per chunk (the
    psum's transpose too); the gradients of the 4L + 1 leaves replicated
    over model (ln1, ln2, wk, wv; final_norm) summed over it, and the
    norm's one psum; the 8L + 2 leaves summed over data and the loss's
    pmean."""
    ag = accum * 2 * (2 * layers + 1)
    return {"all-gather over model": ag, "reduce-scatter over model": ag,
            "all-reduce over model": accum * chunks * 3 + 4 * layers + 2,
            "all-reduce over data": 8 * layers + 3}


def test_dryrun_record_of_a_partitioned_train_cell():
    mesh = make_mesh((2, 4), ("data", "model"), ["meta"] * 8)
    cell = P_steps.build_cell(DANUBE, "train_4k", mesh, depth_override=1)
    assert cell.partitioned and cell.accum == 2
    rec = dryrun.measure(cell)
    counts = dryrun.by_axes(rec.pop("recorded"))
    assert counts == _expected_counts(1, cell.accum, 4096 // 1024)
    mem = rec["memory"]
    assert not mem["temp_at_full_model_width"]
    args = dryrun.rank_share(cell)
    assert args[0]["blocks"]["0"]["attn"]["wq"].shape == (3840, 8, 120)
    assert args[2]["tokens"].shape == (128, 4096)


def test_fits_against_the_cards_own_memory():
    assert dryrun.HBM_BYTES == 85_017_493_504
    assert dryrun.HBM_SPEC_BYTES == 80 * 1024**3
    assert not dryrun.fits_h100(int(79.5 * 2**30))
    assert dryrun.fits_h100(dryrun.HBM_BYTES)


def test_switch_pipeline_ops_entry():
    from repro_torch.kernels.switch_pipeline import kernel, ops
    assert ops.switch_pipeline is kernel.switch_pipeline
