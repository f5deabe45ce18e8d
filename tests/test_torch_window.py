"""The port's multi-tick window path against the JAX package.

* ``simulate(backend="cuda", tick_window=tw)`` for ``tw`` in {1, 5, 7}
  against the reference ``simulate`` (legacy PRNG), base/sym_on/pq_on.
* ``engine_window_fused`` (on CPU tensors: the window kernel's plain
  version) against the reference ``window_ref`` for one 5-tick window from a
  20-tick warm state.
* ``run_window`` with ``tick_window=5`` over uneven splits equals one shot
  and never changes the state it is given.
* ``tick_window > 1`` on a backend that resolves to the eager tick raises.

Tolerances (ROADMAP queue 3): integer outputs and ``ts_alpha_max`` exact;
floats rtol 1e-5, with an absolute floor of 1e-3 for the byte counts
``q``/``sent``/``ts_qmax`` and 1e-6 elsewhere (the reference contracts
``a*b+c`` into fused multiply-adds, the port rounds twice).
The CUDA window kernel itself is held against its plain version on the
card by ``chip_smoke.py``.
"""
import copy
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.netsim as R  # noqa: E402
from repro.core.netsim.simulator import wl_arrays as r_wl_arrays  # noqa: E402,E501
from repro.core.netsim.stages import engine_tick_xla  # noqa: E402
from repro.core.netsim.stages import init_state as r_init_state  # noqa: E402
from repro.core.netsim.stages import make_ctx as r_make_ctx  # noqa: E402
from repro.kernels.netsim_tick.ref import window_ref as r_window_ref  # noqa: E402,E501

import repro_torch.core.netsim as T  # noqa: E402
from repro_torch.core.netsim import convert, prng  # noqa: E402
from repro_torch.core.netsim.stages import make_ctx as t_make_ctx  # noqa: E402
from repro_torch.kernels.netsim_tick import ops  # noqa: E402

ATOL = {"q": 1e-3, "sent": 1e-3, "ts_qmax": 1e-3}
VARIANTS = {"base": {}, "sym_on": {"sym_on": True}, "pq_on": {"pq_on": True}}
N_TICKS = 600


def _small(mod):
    """The 8-host leaf-spine of the reference's window tests, with 0.5 MB
    chunks so that the job finishes inside the horizon (~550 ticks)."""
    topo = mod.make_leaf_spine(8, 2, 2)
    b = mod.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(8)), ring_size=4, chunk_bytes=5e5,
                   passes=1, barrier=False)
    return topo, b.build()


def _cfg(**kw):
    return R.SimParams(n_ticks=N_TICKS, window=16, record_every=20, **kw)


def _port(cfg, **kw):
    return T.SimParams(**cfg._replace(**kw)._asdict())


@functools.lru_cache(maxsize=None)
def _reference(variant):
    topo, wl = _small(R)
    with jax.threefry_partitionable(False):
        res = R.simulate(topo, wl, _cfg(**VARIANTS[variant]),
                         routing="ecmp", seed=3)
        return jax.tree.map(np.asarray, res)


def _assert_close(name, port, ref):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    ref = np.asarray(ref)
    if np.issubdtype(ref.dtype, np.integer) or name == "ts_alpha_max":
        assert np.array_equal(port, ref), name
    else:
        np.testing.assert_allclose(port, ref, rtol=1e-5,
                                   atol=ATOL.get(name, 1e-6), err_msg=name)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("tw", [1, 5, 7])
def test_tick_window_matches_reference(tw, variant):
    ref = _reference(variant)
    topo, wl = _small(T)
    cfg = _port(_cfg(**VARIANTS[variant]), backend="cuda", tick_window=tw)
    port = T.simulate(topo, wl, cfg, routing="ecmp", seed=3, device="cpu")
    for f in T.SimResult._fields:
        _assert_close(f, getattr(port, f), getattr(ref, f))
    assert int(port.job_finish_ticks[0]) < T.stages.I32MAX


def test_window_fused_matches_reference_window_ref():
    topo, wl = _small(R)
    cfg = _cfg(sym_on=True, pq_on=True, sym_win_ticks=5, cc_epoch_ticks=3)
    st = R.build_static(topo, wl, "ecmp", seed=3, dt=cfg.dt,
                        deploy=cfg.deploy)
    wla = r_wl_arrays(wl, cfg.dt)
    struct, knobs = cfg.split()
    warm, n = 20, 5
    with jax.threefry_partitionable(False):
        ctx = r_make_ctx(st, wla, cfg.window)
        state = r_init_state(ctx, jax.random.PRNGKey(3))
        tick_fn = jax.jit(lambda s, t, kn: engine_tick_xla(
            ctx, R.merge_params(struct, kn), s, t))
        for t in range(warm):
            state, _ = tick_fn(state, np.int32(t), knobs)
        ref_state, ref_sample = jax.jit(lambda s, kn: r_window_ref(
            ctx, R.merge_params(struct, kn), s, warm, n))(state, knobs)
    tflat = _port(cfg, backend="cuda", tick_window=n)
    tctx = t_make_ctx(convert.static_from_reference(st, "cpu"),
                      convert.wl_from_reference(wla, "cpu"), cfg.window)
    tcfg = T.merge_params(tflat.structure(), tflat.knobs())
    pstate = convert.engine_state_from_reference(state, "cpu")
    new, sample = ops.engine_window_fused(tctx, tcfg, pstate, warm, n)
    for f in T.EngineState._fields:
        _assert_close(f, getattr(new, f)[0], getattr(ref_state, f))
    names = ("ts_min_wire", "ts_max_wire", "ts_done_min", "ts_throughput",
             "ts_qmax", "ts_alpha_max")
    for f, x, y in zip(names, sample, ref_sample):
        _assert_close(f, x[0], y)


def test_run_window_tick_window_resume_equals_one_shot():
    topo, wl = _small(T)
    cfg = T.SimParams(n_ticks=N_TICKS, window=16, record_every=20,
                      sym_on=True, backend="cuda", tick_window=5)
    st = T.build_static(topo, wl, "ecmp", 3, dt=cfg.dt, device="cpu")
    wla = T.wl_arrays(wl, cfg.dt, device="cpu")
    struct, knobs = cfg.split()
    one = T.simulate_core(st, wla, cfg, prng.prng_key(3, "cpu"))
    sim = T.init_state(st, wla, struct, key=3)
    parts = []
    for n in (100, 60, 240, 200):
        given, copied = sim, copy.deepcopy(sim)
        sim, smp = T.run_window(st, wla, struct, knobs, given, n)
        parts.append(smp)
        assert given.tick == copied.tick     # the caller's state is intact
        for f in T.EngineState._fields:
            assert torch.equal(getattr(given.engine, f),
                               getattr(copied.engine, f)), f
    assert sim.tick == N_TICKS
    assert torch.equal(sim.engine.finish[0], one.finish_ticks)
    assert torch.equal(sim.engine.job_finish[0], one.job_finish_ticks)
    for f in T.WindowSamples._fields:
        assert torch.equal(torch.cat([getattr(p, f) for p in parts]),
                           getattr(one, f)), f


@pytest.mark.parametrize("opt", [dict(backend="eager"),
                                 dict(backend="cuda", share_policy="wfq")],
                         ids=["eager", "wfq"])
def test_tick_window_needs_the_cuda_backend(opt):
    topo, wl = _small(T)
    cfg = T.SimParams(n_ticks=40, window=8, tick_window=5, **opt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the wfq -> eager fallback note
        with pytest.raises(ValueError, match="tick_window=5 > 1 requires"):
            T.simulate(topo, wl, cfg, seed=0, device="cpu")
