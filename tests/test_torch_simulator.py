"""The port's simulator drivers: lanes, windows, devices, backends.

* A whole small run against the reference's ``simulate`` (legacy PRNG).
* Every lane of ``simulate_seeds``/``simulate_grid`` equals a single
  ``simulate`` of that point, bit for bit within the port.
* A ``run_window`` split equals a one-shot run, bit for bit.
* ``device=None`` needs a card; unported options raise.

The Table-1 goldens live in ``test_torch_golden_*.py``, one 20,000-tick run
per file so that the workers share them out.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.netsim as R  # noqa: E402

import repro_torch.core.netsim as T  # noqa: E402
from repro_torch.core import symphony  # noqa: E402
from repro_torch.core.netsim import metrics, prng  # noqa: E402
from repro_torch.core.netsim import stages  # noqa: E402

INT_FIELDS = ("finish_ticks", "job_finish_ticks", "ts_min_wire",
              "ts_max_wire", "ts_done_min", "ts_alpha_max")


def _small(mod, hosts=8, chunk=2e5):
    topo = mod.make_leaf_spine(hosts, 2, 2)
    b = mod.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(hosts)), ring_size=4, chunk_bytes=chunk,
                   passes=1, barrier=False)
    return topo, b.build()


def _equal(a, b, what):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{what}: {f}"


@pytest.mark.parametrize("variant", [dict(sym_on=True), dict(pq_on=True),
                                     dict(share_policy="drr")],
                         ids=["sym", "pq_on", "drr"])
def test_small_run_matches_reference(variant):
    topo, wl = _small(R)
    cfg = R.SimParams(n_ticks=600, window=16, **variant)
    with jax.threefry_partitionable(False):
        ref = R.simulate(topo, wl, cfg, routing="ecmp", seed=3)
    topo, wl = _small(T)
    tcfg = T.SimParams(**cfg._replace(backend="eager")._asdict())
    port = T.simulate(topo, wl, tcfg, routing="ecmp", seed=3, device="cpu")
    for f in INT_FIELDS:
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              getattr(port, f).numpy()), f
    # float series: rtol 1e-5 (the reference contracts a*b+c into FMAs);
    # the queue in bytes gets an absolute floor of 1e-3 (its terms' ulp),
    # the throughput in bytes/s 1e-6.  Seen: 1.6e-2 on ts_qmax ~1e5 and
    # 5.1e2 on ts_throughput ~7e9, both inside rtol.
    for f, atol in (("ts_throughput", 1e-6), ("ts_qmax", 1e-3)):
        np.testing.assert_allclose(getattr(port, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=atol, err_msg=f)
    assert int(port.job_finish_ticks[0]) < T.stages.I32MAX


@pytest.mark.parametrize("backend", ["eager", "cuda"])
def test_seed_lanes_equal_single_runs(backend):
    topo, wl = _small(T)
    cfg = T.SimParams(n_ticks=400, window=16, sym_on=True, backend=backend)
    seeds = [0, 3, 5]
    many = T.simulate_seeds(topo, wl, cfg, "ecmp", seeds, device="cpu")
    for i, s in enumerate(seeds):
        one = T.simulate(topo, wl, cfg, routing="ecmp", seed=s, device="cpu")
        _equal(T.SimResult(*(x[i] for x in many)), one, f"seed {s}")


def test_grid_lanes_equal_single_runs():
    topo, wl = _small(T)
    base = T.SimParams(n_ticks=400, window=16)
    pts = [base, base._replace(sym_on=True),
           base._replace(sym_on=True, pq_on=True),
           base._replace(sym_on=True, sym=base.sym._replace(tau=0.5),
                         cc_epoch_ticks=4)]
    struct, knobs = T.grid_from_params(pts)
    seeds = [1, 2]
    grid = T.simulate_grid(topo, wl, struct, knobs, seeds, routing="ecmp",
                           chunk_knobs=3, device="cpu")
    assert grid.finish_ticks.shape[:2] == (4, 2)
    for k, p in enumerate(pts):
        for i, s in enumerate(seeds):
            one = T.simulate(topo, wl, p, routing="ecmp", seed=s,
                             device="cpu")
            _equal(T.SimResult(*(x[k, i] for x in grid)), one,
                   f"point {k} seed {s}")


def test_run_window_split_equals_one_shot():
    topo, wl = _small(T)
    cfg = T.SimParams(n_ticks=400, window=16, sym_on=True, record_every=20)
    st = T.build_static(topo, wl, "ecmp", 3, dt=cfg.dt, device="cpu")
    wla = T.wl_arrays(wl, cfg.dt, device="cpu")
    struct, knobs = cfg.split()
    one = T.simulate_core(st, wla, cfg, prng.prng_key(3, "cpu"))
    sim = T.init_state(st, wla, struct, key=3)
    parts = []
    for n in (100, 60, 240):
        sim, smp = T.run_window(st, wla, struct, knobs, sim, n)
        parts.append(smp)
    assert sim.tick == 400
    assert torch.equal(sim.engine.finish[0], one.finish_ticks)
    assert torch.equal(sim.engine.job_finish[0], one.job_finish_ticks)
    for f in T.WindowSamples._fields:
        assert torch.equal(torch.cat([getattr(p, f) for p in parts]),
                           getattr(one, f)), f
    with pytest.raises(ValueError):
        T.run_window(st, wla, struct, knobs, sim, 30)


def test_metrics_read_port_results():
    topo, wl = _small(T)
    cfg = T.SimParams(n_ticks=600, window=16, sym_on=True)
    res = T.simulate(topo, wl, cfg, seed=3, device="cpu")
    cct = metrics.cct_seconds(res, wl, cfg)
    assert np.isfinite(cct).all()
    assert cct[0] == pytest.approx(int(res.job_finish_ticks[0]) * cfg.dt)
    t, ov = metrics.overlap_series(res, cfg)
    assert ov.shape == t.shape and ov.max() >= 1
    stats = metrics.window_summary(res)
    assert stats.alpha_max >= 1.0


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    topo, wl = _small(T)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.simulate(topo, wl, T.SimParams(n_ticks=20, window=8), seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.simulate_seeds(topo, wl, T.SimParams(n_ticks=20, window=8),
                         "ecmp", [0, 1])
    # the builders of prepared arrays follow the same rule
    for build in (lambda: T.build_static(topo, wl, "ecmp", 0),
                  lambda: T.wl_arrays(wl, 10e-6),
                  lambda: prng.prng_key(0),
                  lambda: symphony.init_state()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


@pytest.mark.parametrize("opt", [dict(segsum="onehot"), dict(blk=64),
                                 dict(tick_window=5)],
                         ids=["onehot", "blk", "tick_window"])
def test_unported_options_raise(opt):
    topo, wl = _small(T)
    cfg = T.SimParams(n_ticks=20, window=8, backend="cuda", **opt)
    with pytest.raises(NotImplementedError):
        T.simulate(topo, wl, cfg, seed=0, device="cpu")


def test_cuda_backend_wfq_falls_back_with_one_warning(monkeypatch):
    monkeypatch.setattr(stages, "_FALLBACK_WARNED", set())
    topo, wl = _small(T)
    cfg = T.SimParams(n_ticks=100, window=8, share_policy="wfq")
    eager = T.simulate(topo, wl, cfg, seed=0, device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fused = T.simulate(topo, wl, cfg._replace(backend="cuda"), seed=0,
                           device="cpu")
    assert sum("falls back" in str(w.message) for w in rec) == 1
    _equal(eager, fused, "wfq fallback")


@pytest.mark.parametrize("cfg", [dict(share_policy="wfq", pq_on=True),
                                 dict(share_policy="fifo"),
                                 dict(backend="xla")],
                         ids=["pq_over_wfq", "unknown_policy",
                              "unknown_backend"])
def test_invalid_configs_raise(cfg):
    topo, wl = _small(T)
    with pytest.raises(ValueError):
        T.simulate(topo, wl, T.SimParams(n_ticks=20, window=8, **cfg),
                   seed=0, device="cpu")
