"""The port's training runtime, one for one with ``tests/test_runtime.py``
(lines 29-130): the loss falls, checkpoint/restart replays the straight
run, an injected failure recovers, checkpoints restore onto the like tree's
device and dtype, CRCs catch corruption, keep-k, data determinism, the
straggler monitor; and the runtime's device rule.  The smoke model runs on
the CPU; the checkpoint/restart comparison keeps the reference's relative
1e-4 (on the CPU the two runs agree to the bit)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import init_opt_state  # noqa: E402
from repro_torch.runtime import (SimulatedFailure, StragglerMonitor,  # noqa: E402,E501
                                 Trainer)


def _tiny_cfg():
    return registry.get_config("h2o_danube_3_4b", smoke=True)


def _tcfg(tmp, steps=8, every=3):
    return TrainConfig(global_batch=4, seq_len=32, lr=1e-2, warmup_steps=2,
                       total_steps=steps, ckpt_every=every, ckpt_keep=2,
                       ckpt_dir=str(tmp), ckpt_async=False, seed=1)


def _par():
    return ParallelConfig(remat="none", scan_layers=False)


def test_loss_decreases(tmp_path):
    cfg = _tiny_cfg()
    model = build_model(cfg, device="cpu")
    tr = Trainer(model, cfg, _tcfg(tmp_path, steps=30, every=100), _par())
    rep = tr.run()
    first = np.mean(rep.losses[:5])
    last = np.mean(rep.losses[-5:])
    assert last < first - 0.2, (first, last)


def test_checkpoint_restart_bit_exact(tmp_path):
    """Training 8 steps straight == 5 steps, restart, 3 more."""
    cfg = _tiny_cfg()
    model = build_model(cfg, device="cpu")
    t1 = Trainer(model, cfg, _tcfg(tmp_path / "a", steps=8, every=4), _par())
    rep1 = t1.run()

    t2 = Trainer(model, cfg, _tcfg(tmp_path / "b", steps=8, every=4), _par())
    t2.run(steps=5)                  # stops after step 4, ckpts at 3 and 4
    t3 = Trainer(model, cfg, _tcfg(tmp_path / "b", steps=8, every=4), _par())
    rep2b = t3.run(steps=8)          # resumes from ckpt
    # the resumed run replays the steps after the last checkpoint (the
    # first run also saves at its last step, 4) and must match the
    # straight run
    assert rep2b.losses[-1] == pytest.approx(rep1.losses[-1], rel=1e-4)
    assert rep2b.losses == rep1.losses[5:]


def test_failure_injection_recovers(tmp_path):
    cfg = _tiny_cfg()
    model = build_model(cfg, device="cpu")
    crashed = {"done": False}

    def injector(step):
        if step == 5 and not crashed["done"]:
            crashed["done"] = True
            raise SimulatedFailure("node lost")

    tr = Trainer(model, cfg, _tcfg(tmp_path, steps=8, every=2), _par(),
                 failure_injector=injector)
    rep = tr.run()
    assert rep.restarts == 1
    assert np.isfinite(rep.final_loss)


def test_elastic_restore_different_sharding(tmp_path):
    """A checkpoint restores onto the like tree's device and dtypes."""
    mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
    tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
            "opt": {"m": np.ones((8, 8), np.float32)},
            "b": torch.arange(6, dtype=torch.bfloat16) / 7}
    mgr.save(3, tree, {"step": 3})
    like = {"w": torch.empty((8, 8), dtype=torch.float32),
            "opt": {"m": torch.empty((8, 8), dtype=torch.float64)},
            "b": torch.empty(6, dtype=torch.bfloat16)}
    restored, extra = mgr.restore(3, like)
    assert extra["step"] == 3
    np.testing.assert_array_equal(restored["w"].numpy(), tree["w"])
    assert restored["opt"]["m"].dtype == torch.float64
    assert torch.equal(restored["b"], tree["b"])      # bf16 bits round-trip
    manifest = (tmp_path / "step_00000003" / "manifest.json").read_text()
    assert '"dtype": "bfloat16"' in manifest
    assert np.load(tmp_path / "step_00000003" / "b.npy").dtype == np.uint16


def test_checkpoint_crc_detects_corruption(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
    tree = {"w": np.ones((4, 4), np.float32)}
    mgr.save(1, tree, {"step": 1})
    victim = next((tmp_path / "step_00000001").glob("*.npy"))
    arr = np.load(victim)
    arr[0, 0] = 999.0
    np.save(victim, arr)
    with pytest.raises(IOError):
        mgr.restore(1, {"w": torch.empty((4, 4))})


def test_checkpoint_keep_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
    for s in range(5):
        mgr.save(s, {"w": np.zeros(3, np.float32)}, {"step": s})
    assert mgr.list_steps() == [3, 4]


def test_data_determinism_and_sharding():
    cfg = DataConfig(vocab_size=97, seq_len=16, global_batch=8, seed=7)
    d1, d2 = SyntheticLM(cfg), SyntheticLM(cfg)
    t1, l1 = d1.batch(11)
    t2, l2 = d2.batch(11)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(l1, l2)
    # labels are next tokens
    np.testing.assert_array_equal(t1[:, 1:], l1[:, :-1])
    # shards partition deterministically per (step, shard)
    a0, _ = d1.batch(5, shard=0, n_shards=2)
    a1, _ = d1.batch(5, shard=1, n_shards=2)
    assert a0.shape == (4, 16)
    assert not np.array_equal(a0, a1)


def test_straggler_monitor_flags_outlier():
    m = StragglerMonitor()
    for s in range(20):
        assert not m.observe(s, 0.1 + 0.001 * (s % 3))
    assert m.observe(20, 1.5)
    assert len(m.events) == 1


def test_default_device_needs_a_card(monkeypatch):
    """``device=None`` means the CUDA card: the model and the trainer's
    state land there or nowhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(_tiny_cfg())


def test_trainer_runs_on_the_models_device(tmp_path):
    cfg = _tiny_cfg()
    model = build_model(cfg, device="cpu")
    tr = Trainer(model, cfg, _tcfg(tmp_path, steps=2, every=100), _par())
    assert tr.device == torch.device("cpu")
    rep = tr.run()
    assert rep.steps_run == 2
    params = dict(model.named_parameters())
    (restored, opt), extra = tr.ckpt.restore(
        1, (params, init_opt_state(params, tr.tcfg)))
    assert extra == {"step": 1} and int(opt.step) == 2
    for name, p in model.named_parameters():
        assert restored[name].device == p.device
        assert torch.equal(restored[name], p.detach()), name
