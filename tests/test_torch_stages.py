"""The port's eager tick against the reference's staged XLA tick.

Tick for tick: at every tick the reference state is carried across
(``repro_torch.core.netsim.convert``), both engines advance it by one tick,
and the next states are compared — integer state exactly, float state
allclose at rtol=1e-5 (XLA's CPU code contracts ``a*b+c`` into fused
multiply-adds; the port rounds twice).  The absolute floor is per field.
The byte counts ``q`` and ``sent`` get 1e-3: queues integrate
``(offered - cap) * dt`` down to near zero and sends count up from zero in
terms of ~1e4 bytes a tick, whose ulp is ~1e-3.  Every other float field
is a rate (~1e9, where rtol governs), a packet count or lies in [0, 64],
and gets 1e-6.  Largest deviations seen beyond rtol: 4.5e-4 (``sent``),
3.2e-4 (``q``), 3.9e-7 (``lam``), 0 for the rest.  The reference runs with
the legacy threefry PRNG, the mode its goldens were captured in.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.netsim import (SimParams, WorkloadBuilder, build_static,
                               make_fat_tree, make_leaf_spine, merge_params)
from repro.core.netsim.simulator import wl_arrays
from repro.core.netsim.stages import engine_tick_xla, init_state, make_ctx

import repro_torch.core.netsim as T
from repro_torch.core.netsim import convert
from repro_torch.core.netsim.stages import (engine_tick_eager,
                                            make_ctx as t_make_ctx,
                                            ordered_segment_sum)

N_TICKS = 300
RTOL = 1e-5
ATOL = 1e-6
BYTE_ATOL = {"q": 1e-3, "sent": 1e-3}     # byte counts, see the docstring


def _fabric(kind):
    if kind == "leaf_spine":
        topo = make_leaf_spine(8, 2, 2)
        hosts, ring = list(range(8)), 4
    else:
        topo = make_fat_tree(2, 2, 2, 2)
        hosts, ring = list(range(topo.n_hosts)), 4
    b = WorkloadBuilder()
    b.add_ring_job(hosts=hosts, ring_size=ring, chunk_bytes=2e5, passes=1,
                   barrier=False)
    return topo, b.build()


VARIANTS = {
    "proportional_sym": dict(sym_on=True),
    "pq_policy": dict(share_policy="pq", sym_on=True),
    "wfq": dict(share_policy="wfq", sym_on=True),
    "drr": dict(share_policy="drr"),
    "pq_on_gate": dict(pq_on=True, sym_on=True),
    "static_routes": dict(per_step_ecmp=False, sym_on=True),
    "background": dict(sym_on=True),
}


def _assert_state(ref, port, where):
    for f in ref._fields:
        a = np.asarray(getattr(ref, f))
        b = getattr(port, f)[0].numpy()
        if f == "key":
            assert np.array_equal(a.astype(np.int64), b), f"{where}: {f}"
        elif a.dtype.kind in "iu":
            assert np.array_equal(a, b), f"{where}: {f}"
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL,
                                       atol=BYTE_ATOL.get(f, ATOL),
                                       err_msg=f"{where}: {f}")


@pytest.mark.parametrize("kind", ["leaf_spine", "fat_tree"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_eager_tick_matches_reference_tick_for_tick(kind, variant):
    topo, wl = _fabric(kind)
    cfg = SimParams(n_ticks=N_TICKS, window=8, **VARIANTS[variant])
    bg = {}
    if variant == "background":
        rng = np.random.default_rng(0)
        bg = dict(bg_base=rng.uniform(0, 3e8, topo.n_links),
                  bg_amp=rng.uniform(0, 3e8, topo.n_links),
                  bg_period=2e-4, bg_duty=0.5)
    st = build_static(topo, wl, "ecmp", seed=3, dt=cfg.dt, deploy=cfg.deploy,
                      **bg)
    wla = wl_arrays(wl, cfg.dt)
    struct, knobs = cfg.split()
    with jax.threefry_partitionable(False):
        ctx = make_ctx(st, wla, cfg.window)
        state = init_state(ctx, jax.random.PRNGKey(3))
        tick_fn = jax.jit(lambda s, t, kn: engine_tick_xla(
            ctx, merge_params(struct, kn), s, t))
        tctx = t_make_ctx(convert.static_from_reference(st, "cpu"),
                          convert.wl_from_reference(wla, "cpu"), cfg.window)
        tflat = T.SimParams(**cfg._replace(backend="eager")._asdict())
        tcfg = T.merge_params(tflat.structure(), tflat.knobs())
        for tick in range(N_TICKS):
            port_in = convert.engine_state_from_reference(state, "cpu")
            state, _ = tick_fn(state, np.int32(tick), knobs)
            port_out, _ = engine_tick_eager(tctx, tcfg, port_in, tick, False)
            _assert_state(state, port_out, f"{kind}/{variant} tick {tick}")
    # the run went somewhere: steps completed
    assert int(np.asarray(state.done_upto).min()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordered_segment_sum_equals_np_add_at(seed):
    """Heavy duplicates, two lanes: bit for bit the order of np.add.at."""
    rng = np.random.default_rng(seed)
    B, R, E = 2, 7, 5000
    base = rng.uniform(0, 10, (B, R)).astype(np.float32)
    idx = rng.integers(0, R, (B, E))
    vals = (rng.uniform(0, 1e6, (B, E)) *
            rng.integers(0, 2, (B, E))).astype(np.float32)
    want = base.copy()
    for b in range(B):
        np.add.at(want[b], idx[b], vals[b])
    got = ordered_segment_sum(torch.from_numpy(base), torch.from_numpy(idx),
                              torch.from_numpy(vals))
    assert np.array_equal(got.numpy(), want)
