"""The fused netsim tick's plain torch version against the reference kernel.

The reference's ``kernels.netsim_tick.fused_tick`` runs in Pallas interpret
mode on a mid-run state; the same state is carried across to the port
(``convert``) and through ``kernel.netsim_tick``, which on CPU tensors runs
the CUDA kernel's plain version.  Integer outputs must be equal; float
outputs allclose at rtol=1e-5 (the reference's jitted body contracts
``a*b+c`` into fused multiply-adds), with an absolute floor of 1e-3 for the
queue in bytes (terms of ~1e4 bytes a tick, ulp ~1e-3) and 1e-6 for every
other field (rates, packet counts, ``p_red`` <= 0.2, alpha).  Largest
deviations seen: 7.8e-3 on ``q`` ~1e5, 3.7e-8 on ``p_red``, none beyond
rtol.
The CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.netsim import (SimParams, WorkloadBuilder, build_static,
                               make_leaf_spine, merge_params)
from repro.core.netsim.simulator import wl_arrays
from repro.core.netsim.stages import (engine_tick_xla, init_state, make_ctx,
                                      stage_starts)
from repro.kernels.netsim_tick import fused_tick

import repro_torch.core.netsim as T
from repro_torch.core.netsim import convert
from repro_torch.core.netsim.stages import (make_ctx as t_make_ctx,
                                            stage_starts as t_stage_starts)
from repro_torch.kernels.netsim_tick import kernel as K
from repro_torch.kernels.netsim_tick.ops import tick_operands

WARM = 60
CHECK = 15
RTOL = 1e-5
ATOL = {"q": 1e-3}           # bytes; see the docstring


def _small():
    topo = make_leaf_spine(8, 2, 2)
    b = WorkloadBuilder()
    b.add_ring_job(hosts=list(range(8)), ring_size=4, chunk_bytes=2e5,
                   passes=1, barrier=False)
    return topo, b.build()


@pytest.mark.parametrize("routing", ["ecmp", "ecmp_flow"])
@pytest.mark.parametrize("variant", [
    dict(), dict(sym_on=True), dict(pq_on=True), dict(share_policy="pq")],
    ids=["proportional", "sym_on", "pq_on", "pq_policy"])
def test_plain_tick_matches_reference_kernel(variant, routing):
    topo, wl = _small()
    cfg = SimParams(n_ticks=100, window=8, sym_win_ticks=5,
                    per_step_ecmp=routing == "ecmp", **variant)
    st = build_static(topo, wl, "ecmp", seed=3, dt=cfg.dt, deploy=cfg.deploy)
    wla = wl_arrays(wl, cfg.dt)
    struct, knobs = cfg.split()
    tcfg_flat = T.SimParams(**cfg._replace(backend="eager")._asdict())
    tcfg = T.merge_params(tcfg_flat.structure(), tcfg_flat.knobs())
    with jax.threefry_partitionable(False):
        ctx = make_ctx(st, wla, cfg.window)
        state = init_state(ctx, jax.random.PRNGKey(0))
        tick_fn = jax.jit(lambda s, t, kn: engine_tick_xla(
            ctx, merge_params(struct, kn), s, t))
        kern = jax.jit(lambda s, t, kn: fused_tick(
            ctx, merge_params(struct, kn), stage_starts(ctx, s, t), s, t,
            interpret=True))
        tctx = t_make_ctx(convert.static_from_reference(st, "cpu"),
                          convert.wl_from_reference(wla, "cpu"), cfg.window)
        for tick in range(WARM + CHECK):
            if tick >= WARM:
                ref = kern(state, np.int32(tick), knobs)
                pstate = convert.engine_state_from_reference(state, "cpu")
                starts = t_stage_starts(tctx, pstate, tick)
                args, kw = tick_operands(tctx, tcfg, starts, pstate, tick)
                out = K.netsim_tick(*args, **kw)
                for f in out._fields:
                    a = np.asarray(getattr(ref, f))
                    b = getattr(out, f)[0].numpy()
                    if a.dtype.kind in "iu":
                        assert np.array_equal(a, b), f"tick {tick}: {f}"
                    else:
                        np.testing.assert_allclose(
                            b, a, rtol=RTOL, atol=ATOL.get(f, 1e-6),
                            err_msg=f"tick {tick}: {f}")
            state, _ = tick_fn(state, np.int32(tick), knobs)
    assert int(np.asarray(ref.eff).astype(bool).sum()) > 0


def _operands(B=2):
    """Tiny well-formed operands of the wrapper, two lanes."""
    cfg = T.SimParams(n_ticks=20, window=8)
    ctx, ecfg, sim = T.make_lanes(
        T.make_leaf_spine(8, 2, 2), _port_wl(), cfg.structure(),
        T.stack_knobs([cfg.knobs()] * B), seeds=[0], device="cpu")
    starts = t_stage_starts(ctx, sim.engine, 0)
    return tick_operands(ctx, ecfg, starts, sim.engine, 0)


def _port_wl():
    b = T.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(8)), ring_size=4, chunk_bytes=2e5,
                   passes=1, barrier=False)
    return b.build()


def test_cpu_wrapper_runs_plain_version_without_launching():
    args, kw = _operands()
    before = K.netsim_tick.launches
    out = K.netsim_tick(*args, **kw)
    ref = K.hot_tick(*args, **kw)
    assert K.netsim_tick.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "policy",
                                  "device_mix"])
def test_wrapper_rejects_bad_operands(case):
    args, kw = _operands()
    args = list(args)
    if case == "dtype":
        args[0] = args[0].to(torch.int64)            # step must be int32
        err = TypeError
    elif case == "shape":
        args[4] = args[4][:, :-1].contiguous()       # q_prev one link short
        err = ValueError
    elif case == "contiguity":
        args[1] = args[1].t().contiguous().t()       # sent transposed view
        err = ValueError
    elif case == "policy":
        kw = dict(kw, policy="wfq")
        err = ValueError
    else:
        args[2] = args[2].to("meta")                 # rate on another device
        err = ValueError
    with pytest.raises(err):
        K.netsim_tick(*args, **kw)


# the shape of nvcc -Xptxas -v's report for one library with both
# instantiations of the tick kernel (registers, stack, spills, static smem)
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z18netsim_tick_kernelILb0EEv8TickArgs' for 'sm_90a'
ptxas info    : Function properties for _Z18netsim_tick_kernelILb0EEv8TickArgs
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z18netsim_tick_kernelILb1EEv8TickArgs' for 'sm_90a'
ptxas info    : Function properties for _Z18netsim_tick_kernelILb1EEv8TickArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 64 bytes smem, 1288 bytes cmem[0]
"""


def test_ptxas_report_is_read_per_entry_function():
    """chip_smoke.py's build phase reads each kernel instantiation's
    registers and spills from the build log, and fails on a spill."""
    from repro_torch.kernels import _build
    got = _build.ptxas_entries(PTXAS_LOG)
    assert got == {
        "_Z18netsim_tick_kernelILb0EEv8TickArgs": dict(
            registers=128, stack=16, spill_stores=8, spill_loads=12, smem=0),
        "_Z18netsim_tick_kernelILb1EEv8TickArgs": dict(
            registers=96, stack=0, spill_stores=0, spill_loads=0, smem=64)}
    assert _build.ptxas_entries("") == {}


def test_workspace_holds_the_active_list_at_every_size():
    """The tick wrapper's global workspace: the active-instance list alone
    while the ids fit in shared memory, then the ids after it."""
    small = K.hot_smem_split(2048, 4, 97, 1, 5)
    assert small.ids == 0 and small.ws == 2 * 2048
    big = K.hot_smem_split(16384, 6, 897, 1, 33)
    assert big.ids > 0 and big.ws == 2 * 16384 + big.ids
    assert K.ids_workspace(3, big, "cpu").shape == (3, big.ws)
    with pytest.raises(ValueError, match="uint16"):
        K.hot_smem_split(65537, 1, 97, 1, 5)
