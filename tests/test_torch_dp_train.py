"""Data-parallel training with explicit ring gradient sync against the
reference's ``make_train_step(grad_sync="ring" | "hierarchical")``.

The configuration is ``tests/test_system.py:41-110``'s (dense GQA, 2
layers, d_model 64, heads 4/2, d_ff 128, vocab 256, batch 8 x 32, lr 1e-2,
warmup 2), in float32 (weights cast on both sides), on 4 ranks: mesh (data
4) for ring, (pod 2, data 2) for hierarchical.  The reference's steps run
once for the file in a child python on 4 virtual CPU devices (jax fixes
the count at its first import), inside ``jax.threefry_partitionable
(False)``; its initial parameters, losses and parameters after each of 3
steps come back as ``.npz``.  The port carries the initial parameters in
(``params_from_reference``) and runs over the CPU named 4 times.

- Parameters after each step within a relative L2 distance of 1e-5 per
  leaf, losses within 1e-6 relative; the four replicas bit-equal after
  every step.
- Ring-synced steps against the port's one-device step on the whole
  batch, at the reference's own 2e-2 (``tests/test_system.py``).
- ``Trainer(mesh=)``: the loss falls, and a restart from a checkpoint
  replays the straight run's losses exactly, with the replicas equal.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.config import (ModelConfig, ParallelConfig,  # noqa: E402
                                TrainConfig)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import (params_from_reference,  # noqa: E402
                                params_to_reference)
from repro_torch.models.params import cast_tree  # noqa: E402
from repro_torch.optim import init_opt_state  # noqa: E402
from repro_torch.runtime import RingStep, Trainer, make_train_step  # noqa: E402,E501

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
MESHES = {"ring": ((4,), ("data",)), "hierarchical": ((2, 2), ("pod", "data"))}
CFG = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
           num_kv_heads=2, d_ff=128, vocab_size=256, attention="gqa",
           dtype="float32")
TRAIN = dict(global_batch=8, seq_len=32, lr=1e-2, warmup_steps=2,
             total_steps=20)
PARAM_REL_L2 = 1e-5
LOSS_RTOL = 1e-6

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.config import ModelConfig, ParallelConfig, TrainConfig
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.models.params import cast_tree
from repro.optim.adamw import init_opt_state
from repro.runtime.train import make_train_step

CFG, TRAIN, MESHES, STEPS = %r, %r, %r, %d
inp = dict(np.load(sys.argv[1]))
cfg = ModelConfig(**CFG)
tcfg = TrainConfig(**TRAIN)
out = {}
flat = lambda t, pre: {pre + jax.tree_util.keystr(p): np.asarray(v,
                       np.float32) for p, v in
                       jax.tree_util.tree_leaves_with_path(t)}
with jax.threefry_partitionable(False):
    for sync, (shape, axes) in MESHES.items():
        mesh = make_mesh(shape, axes)
        par = ParallelConfig(grad_sync=sync, scan_layers=False, remat="none")
        model = build_model(cfg, par, mesh=mesh)
        params = cast_tree(model.init(jax.random.PRNGKey(0)), jnp.float32)
        out.update(flat(params, f"{sync}/init"))
        opt = init_opt_state(params, tcfg)
        step = make_train_step(model, cfg, tcfg, par, mesh)
        for s in range(STEPS):
            batch = {"tokens": jnp.asarray(inp[f"tokens{s}"]),
                     "labels": jnp.asarray(inp[f"labels{s}"])}
            params, opt, m = step(params, opt, batch)
            out[f"{sync}/loss{s}"] = np.float32(m["loss"])
            out.update(flat(params, f"{sync}/step{s}"))
np.savez(sys.argv[2], **out)
print("REFERENCE_DONE")
""" % (CFG, TRAIN, MESHES, STEPS)


def _batches() -> list[dict]:
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 256, (8, 32)).astype(np.int32)
        out.append({"tokens": toks, "labels": np.roll(toks, -1, 1)})
    return out


def _tree(flat: dict, prefix: str) -> dict:
    """The reference's tree from its flattened ``prefix['a']['b']`` keys."""
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "["):
            continue
        path = [p.strip("'") for p in key[len(prefix) + 1:-1].split("][")]
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    inp = {}
    for s, b in enumerate(_batches()):
        inp[f"tokens{s}"], inp[f"labels{s}"] = b["tokens"], b["labels"]
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(d / "in.npz"),
                        str(d / "out.npz")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "REFERENCE_DONE" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def _model(ref: dict, sync: str, mesh=None):
    par = ParallelConfig(grad_sync=sync, scan_layers=False, remat="none")
    model = params_from_reference(ModelConfig(**CFG), _tree(ref, "ring/init"),
                                  "cpu", par=par, mesh=mesh)
    return cast_tree(model, torch.float32), par


def _flat(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _replicas_equal(step: RingStep) -> bool:
    first = list(step.replicas[0].parameters())
    return all(torch.equal(a, b) for r in step.replicas[1:]
               for a, b in zip(first, r.parameters()))


@pytest.mark.parametrize("sync", list(MESHES))
def test_ring_training_matches_reference(data, sync):
    shape, axes = MESHES[sync]
    mesh = make_mesh(shape, axes, ["cpu"] * 4)
    model, par = _model(data, sync, mesh)
    np.testing.assert_array_equal(
        params_to_reference(model)["embed"]["embedding"],
        _tree(data, f"{sync}/init")["embed"]["embedding"])
    tcfg = TrainConfig(**TRAIN)
    step = make_train_step(model, model.cfg, tcfg, par, mesh)
    assert isinstance(step, RingStep) and len(step.replicas) == 4
    opt = init_opt_state(dict(model.named_parameters()), tcfg)
    for s, b in enumerate(_batches()):
        opt, met = step(opt, _torch_batch(b))
        np.testing.assert_allclose(float(met["loss"]), data[f"{sync}/loss{s}"],
                                   rtol=LOSS_RTOL)
        assert _replicas_equal(step), f"step {s}: replicas differ"
        want = _flat(_tree(data, f"{sync}/step{s}"))
        got = _flat(params_to_reference(model))
        assert got.keys() == want.keys()
        for k, w in want.items():
            rel = np.linalg.norm(got[k] - w) / np.linalg.norm(w)
            assert rel <= PARAM_REL_L2, (s, k, rel)


def test_ring_against_one_device(data):
    """The reference's check of ring against GSPMD's sync, here against
    the port's one-device step on the whole batch: 2e-2."""
    mesh = make_mesh((4,), ("data",), ["cpu"] * 4)
    tcfg = TrainConfig(**TRAIN)
    out = {}
    for sync in ("ring", "xla"):
        model, par = _model(data, sync, mesh if sync == "ring" else None)
        step = make_train_step(model, model.cfg, tcfg, par,
                               mesh if sync == "ring" else None)
        opt = init_opt_state(dict(model.named_parameters()), tcfg)
        for b in _batches():
            opt, met = step(opt, _torch_batch(b))
        out[sync] = ([p.detach().clone() for p in model.parameters()],
                     float(met["loss"]))
    for a, b in zip(out["ring"][0], out["xla"][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2,
                                   rtol=2e-2)
    assert abs(out["ring"][1] - out["xla"][1]) < 1e-2


def test_ring_grads_are_the_global_batch_gradients(data):
    """RingStep.grads: every rank holds the same synced gradients, the
    mean of the ranks' own, i.e. the one-device gradient of the whole
    batch (float32: 1e-5)."""
    mesh = make_mesh((4,), ("data",), ["cpu"] * 4)
    model, par = _model(data, "ring", mesh)
    step = make_train_step(model, model.cfg, TrainConfig(**TRAIN), par, mesh)
    batch = _torch_batch(_batches()[0])
    loss, grads = step.grads(batch)
    params = dict(model.named_parameters())
    logits, aux = model.apply(batch["tokens"])
    from repro_torch.launch.steps import cross_entropy
    whole = cross_entropy(logits[..., :256], batch["labels"]) + aux
    want = torch.autograd.grad(whole, list(params.values()))
    assert abs(float(loss) - float(whole.detach())) <= \
        1e-6 * abs(float(whole.detach()))
    for g in grads[1:]:
        assert all(torch.equal(g[n], grads[0][n]) for n in params)
    for n, w in zip(params, want):
        np.testing.assert_allclose(grads[0][n].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def test_tensor_parallel_mesh_is_refused(data):
    """Under a model axis > 1: a family outside tensor parallelism's slice
    (the VLM) raises NotImplementedError naming its ROADMAP item; a dense
    GQA model built without the mesh raises ValueError."""
    from repro_torch.configs import registry
    from repro_torch.models import build_model
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    vlm = registry.get_config("qwen2_vl_2b", smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.*left 6"):
        make_train_step(build_model(vlm, device="cpu"), vlm,
                        TrainConfig(**TRAIN), ParallelConfig(), mesh)
    model, par = _model(data, "ring", None)
    with pytest.raises(ValueError, match="built on its mesh"):
        make_train_step(model, model.cfg, TrainConfig(**TRAIN), par, mesh)


def test_trainer_over_a_mesh_learns_and_restarts(data, tmp_path):
    """Trainer(mesh=) on SyntheticLM batches of 4 x 32 (one sequence a
    rank): the loss falls over 20 steps; 5 steps, then a new trainer
    resuming from the checkpoint to 8, give the straight run's losses."""
    mesh = make_mesh((2, 2), ("pod", "data"), ["cpu"] * 4)

    def trainer(name, steps, every):
        model, par = _model(data, "hierarchical", mesh)
        tcfg = TrainConfig(global_batch=4, seq_len=32, lr=1e-2,
                           warmup_steps=2, total_steps=steps,
                           ckpt_every=every, ckpt_keep=2,
                           ckpt_dir=str(tmp_path / name), ckpt_async=False,
                           seed=1)
        return Trainer(model, model.cfg, tcfg, par, mesh=mesh)

    t = trainer("loss", 20, 100)
    rep = t.run()
    assert np.mean(rep.losses[-4:]) < np.mean(rep.losses[:4]) - 0.2, \
        rep.losses
    assert _replicas_equal(t.step_fn)
    straight = trainer("a", 8, 4).run()
    trainer("b", 8, 4).run(steps=5)
    t = trainer("b", 8, 4)
    resumed = t.run(steps=8)
    assert resumed.losses == straight.losses[5:]
    assert _replicas_equal(t.step_fn)
