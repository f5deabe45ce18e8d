"""The port's online control plane against the JAX package's.

* ``apply_action`` retunes the same fields to the same values and dtypes,
  and raises the same errors; on stacked knobs it keeps shape and device.
* ``SimController`` (``backend="cuda"``, ``tick_window=5``: the window
  path, on CPU tensors its plain version) steps, runs, checkpoints,
  restores and resets like the reference's controller over 400 ticks:
  observations and samples equal, and a rewind replays bit for bit.
* A reference checkpoint, carried across by ``sim_state_from_reference``
  and continued in the port, equals the reference continuing.

Tolerances (ROADMAP queue 3): integers and ``ts_alpha_max`` exact; float
series rtol 1e-5 with an absolute floor of 1e-3 for ``ts_qmax`` (bytes)
and 1e-6 for ``ts_throughput``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.netsim as R  # noqa: E402
from repro.core.netsim.control import ACTION_FIELDS  # noqa: E402

import repro_torch.core.netsim as T  # noqa: E402
from repro_torch.core.netsim import convert  # noqa: E402

ATOL = {"ts_qmax": 1e-3, "qmax": 1e-3, "q_last": 1e-3}
WINDOW = 80
ACTIONS = (None, None, {"tau": 0.1, "k": 0.02}, {"red_pmax": 0.5},
           {"sym_on": False, "alpha_max": 8.0})


def _small(mod):
    topo = mod.make_leaf_spine(8, 2, 2)
    b = mod.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(8)), ring_size=4, chunk_bytes=3e5,
                   passes=1, barrier=False)
    return topo, b.build()


def _cfg():
    return R.SimParams(n_ticks=400, window=16, record_every=20, sym_on=True)


def _port_cfg():
    return T.SimParams(**_cfg()._replace(backend="cuda",
                                         tick_window=5)._asdict())


def _close(name, port, ref):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    ref = np.asarray(ref)
    if np.issubdtype(ref.dtype, np.integer) or np.issubdtype(
            ref.dtype, np.bool_) or "alpha" in name:
        assert np.array_equal(port, ref), name
    else:
        np.testing.assert_allclose(port, ref, rtol=1e-5,
                                   atol=ATOL.get(name, 1e-6), err_msg=name)


def _obs_equal(port, ref):
    assert port.tick == int(ref.tick)
    assert port.t == pytest.approx(float(ref.t))
    assert port.done == bool(ref.done)
    _close("job_finished", port.job_finished, ref.job_finished)
    for f in port.stats._fields:
        _close(f, getattr(port.stats, f), getattr(ref.stats, f))
    for f in port.samples._fields:
        _close(f, getattr(port.samples, f), getattr(ref.samples, f))


def _state_equal(a, b):
    assert a.tick == b.tick
    for x, y in zip(a.engine, b.engine):
        assert torch.equal(x, y)


def _pair():
    topo, wl = _small(R)
    with jax.threefry_partitionable(False):
        ref = R.SimController(topo, wl, _cfg(), window_ticks=WINDOW, seed=3)
    topo, wl = _small(T)
    port = T.SimController(topo, wl, _port_cfg(), window_ticks=WINDOW,
                           seed=3, device="cpu")
    return ref, port


# ------------------------------------------------------------ apply_action
@pytest.mark.parametrize("action", [
    {"tau": 0.3}, {"k": 0.05, "n_warmup": 4, "n_sample": 8.0},
    {"alpha_max": 16.0, "red_pmax": 0.9, "sym_on": True},
    {"cc_epoch_ticks": 4, "cc_fr_stages": 3.0, "pq_on": 1,
     "sym_win_ticks": 20, "sym_start_tick": 100, "cc_g": 0.125}],
    ids=["tau", "sym_fields", "mixed", "ints"])
def test_apply_action_matches_reference(action):
    with jax.threefry_partitionable(False):
        ref = R.apply_action(R.SimParams().knobs(), action)
    port = T.apply_action(T.SimParams().knobs(), action)
    names = [f for f in T.RuntimeKnobs._fields if f != "sym"]
    flat = [getattr(port, f) for f in names] + list(port.sym)
    rflat = [np.asarray(getattr(ref, f)) for f in names] + \
        [np.asarray(x) for x in ref.sym]
    assert len(flat) == len(jax.tree.leaves(ref))
    for x, y in zip(flat, rflat):
        assert str(x.dtype).split(".")[-1] == str(y.dtype)
        assert tuple(x.shape) == y.shape
        assert x.item() == y.item()
    assert set(T.ACTION_FIELDS) == set(ACTION_FIELDS)


def test_apply_action_errors_and_stacked_knobs():
    knobs = T.SimParams().knobs()
    for bad, msg in (({"bogus": 1.0}, "unknown action field"),
                     ({"sym": None}, "individually")):
        with pytest.raises(ValueError, match=msg), \
                jax.threefry_partitionable(False):
            R.apply_action(R.SimParams().knobs(), bad)
        with pytest.raises(ValueError, match=msg):
            T.apply_action(knobs, bad)
    grid = T.stack_knobs([T.SimParams().knobs()] * 3)
    new = T.apply_action(grid, {"tau": 0.5, "sym_on": True})
    assert new.sym.tau.shape == (3,) and new.sym.tau.dtype == torch.float32
    assert new.sym_on.tolist() == [1, 1, 1]
    assert new.sym.k is grid.sym.k          # untouched leaves stay shared
    per_lane = T.apply_action(grid, {"red_pmax": [0.1, 0.2, 0.3]})
    assert per_lane.red_pmax.tolist() == pytest.approx([0.1, 0.2, 0.3])


# -------------------------------------------------------------- controller
def test_controller_steps_match_reference():
    ref, port = _pair()
    with jax.threefry_partitionable(False):
        for action in ACTIONS:
            _, robs = ref.step(action)
            _, pobs = port.step(action)
            _obs_equal(pobs, robs)
    assert pobs.tick == 400
    assert pobs.done


def test_controller_run_reset_and_rewind():
    ref, port = _pair()
    with jax.threefry_partitionable(False):
        robs = ref.run(3, policy=lambda obs: {"tau": 0.2})
    pobs = port.run(3, policy=lambda obs: {"tau": 0.2})
    _obs_equal(pobs, robs)
    # rewind: a checkpoint is a CPU copy; restoring it replays bit for bit
    snap = port.checkpoint()
    assert all(x.device.type == "cpu" for x in snap.engine)
    sa, oa = port.step({"k": 0.05})
    sa2, _ = port.step()
    assert snap.tick == 3 * WINDOW and sa2.tick == 5 * WINDOW
    port.restore(snap)
    sb, ob = port.step({"k": 0.05})
    sb2, _ = port.step()
    _state_equal(sa, sb)
    _state_equal(sa2, sb2)
    for f in oa.samples._fields:
        assert torch.equal(getattr(oa.samples, f), getattr(ob.samples, f))
    # reset: back to tick 0, and the first window replays
    first = T.SimController(*_small(T), _port_cfg(), window_ticks=WINDOW,
                            seed=3, device="cpu")
    _, o1 = first.step()
    st0 = port.reset()
    assert st0.tick == 0
    port.knobs = first.knobs
    _, o2 = port.step()
    for f in o1.samples._fields:
        assert torch.equal(getattr(o1.samples, f), getattr(o2.samples, f))


def test_reference_checkpoint_resumes_in_port():
    ref, port = _pair()
    with jax.threefry_partitionable(False):
        ref.step()
        ref.step({"tau": 0.1})
        snap = ref.checkpoint()
        rest = [ref.step()[1] for _ in range(3)]
    port.knobs = T.apply_action(port.knobs, {"tau": 0.1})
    port.restore(convert.sim_state_from_reference(snap, "cpu"))
    assert port.state.tick == 2 * WINDOW
    for robs in rest:
        _, pobs = port.step()
        _obs_equal(pobs, robs)
    jf = np.asarray(ref.state.engine.job_finish)
    assert np.array_equal(port.state.engine.job_finish[0].numpy(), jf)


def test_controller_window_validation():
    topo, wl = _small(T)
    with pytest.raises(ValueError, match="record_every"):
        T.SimController(topo, wl, _port_cfg(), window_ticks=30,
                        device="cpu")


def test_controller_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    topo, wl = _small(T)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.SimController(topo, wl, _port_cfg())
