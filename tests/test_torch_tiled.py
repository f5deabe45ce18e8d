"""The port's tiled tick (``segsum="onehot"``, ``blk``) against the JAX package.

* Per tick: ``tiled.netsim_tiled`` on CPU tensors (the CUDA kernel's plain
  version, ``ref.tiled_tick_ref``) against the reference's
  ``fused_tick(..., segsum="onehot", blk=blk)`` in Pallas interpret mode,
  on mid-run states of the 8-host leaf-spine, ``blk`` in {16 (divides
  FW=64), 24 (does not), 4096 (one whole-axis block)}, sym_on/pq_on lanes,
  per-step ECMP on and off.
* Whole 300-tick runs: port ``backend="cuda", segsum="onehot", blk=blk``
  against the reference's ``backend="pallas"`` with the same settings and
  against the port's ``eager``.
* ``blk`` with ``tick_window=5`` normalizes to the window kernel; the
  structure checks raise the reference's ``ValueError``s; the shared/global
  split of the hot scratch at 128-, 256- and 512-host dimensions.

Tolerances (the reference's own, ``tests/test_netsim_tick_kernel.py``):
integer outputs and series exact; floats rtol 1e-5 and atol 1e-5, since
one-hot contractions and cross-block partials reassociate float adds.  The
CUDA kernel itself is held against its plain version on the card by
``chip_smoke.py``.
"""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.netsim as R  # noqa: E402
from repro.core.netsim import merge_params as r_merge  # noqa: E402
from repro.core.netsim.simulator import wl_arrays as r_wl_arrays  # noqa: E402,E501
from repro.core.netsim.stages import engine_tick_xla  # noqa: E402
from repro.core.netsim.stages import init_state as r_init_state  # noqa: E402
from repro.core.netsim.stages import make_ctx as r_make_ctx  # noqa: E402
from repro.core.netsim.stages import stage_starts as r_stage_starts  # noqa: E402,E501
from repro.kernels.netsim_tick import fused_tick as r_fused_tick  # noqa: E402

import repro_torch.core.netsim as T  # noqa: E402
from repro_torch.core.netsim import convert  # noqa: E402
from repro_torch.core.netsim.stages import make_ctx as t_make_ctx  # noqa: E402
from repro_torch.core.netsim.stages import stage_starts as t_stage_starts  # noqa: E402,E501
from repro_torch.kernels.netsim_tick import kernel as K  # noqa: E402
from repro_torch.kernels.netsim_tick import tiled  # noqa: E402
from repro_torch.kernels.netsim_tick import window as Wn  # noqa: E402
from repro_torch.kernels.netsim_tick.ops import tiled_operands  # noqa: E402

WARM = 40
CHECK = 8
RTOL = ATOL = 1e-5
BLKS = [16, 24, 4096]
VARIANTS = {"sym_on": dict(sym_on=True), "pq_on": dict(pq_on=True)}


def _small(mod):
    topo = mod.make_leaf_spine(8, 2, 2)
    b = mod.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(8)), ring_size=4, chunk_bytes=2e5,
                   passes=1, barrier=False)
    return topo, b.build()


def _port_cfg(cfg, **kw):
    return T.SimParams(**cfg._replace(**kw)._asdict())


def _close(name, port, ref):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    ref = np.asarray(ref)
    if np.issubdtype(ref.dtype, np.integer):
        assert np.array_equal(port, ref), name
    else:
        np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


# ------------------------------------------------- per tick, mid-run states
@pytest.mark.parametrize("routing", ["ecmp", "ecmp_flow"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("blk", BLKS)
def test_tiled_plain_matches_reference_tiled_kernel(blk, variant, routing):
    topo, wl = _small(R)
    cfg = R.SimParams(n_ticks=100, window=8, sym_win_ticks=5,
                      per_step_ecmp=routing == "ecmp", **VARIANTS[variant])
    st = R.build_static(topo, wl, "ecmp", seed=3, dt=cfg.dt,
                        deploy=cfg.deploy)
    wla = r_wl_arrays(wl, cfg.dt)
    struct, knobs = cfg.split()
    tflat = _port_cfg(cfg, backend="cuda", segsum="onehot", blk=blk)
    tcfg = T.merge_params(tflat.structure(), tflat.knobs())
    with jax.threefry_partitionable(False):
        ctx = r_make_ctx(st, wla, cfg.window)
        state = r_init_state(ctx, jax.random.PRNGKey(0))
        tick_fn = jax.jit(lambda s, t, kn: engine_tick_xla(
            ctx, r_merge(struct, kn), s, t))
        kern = jax.jit(lambda s, t, kn: r_fused_tick(
            ctx, r_merge(struct, kn), r_stage_starts(ctx, s, t), s, t,
            segsum="onehot", blk=blk, interpret=True))
        tctx = t_make_ctx(convert.static_from_reference(st, "cpu"),
                          convert.wl_from_reference(wla, "cpu"), cfg.window)
        before = tiled.netsim_tiled.launches
        for tick in range(WARM + CHECK):
            if tick >= WARM:
                ref = kern(state, np.int32(tick), knobs)
                pstate = convert.engine_state_from_reference(state, "cpu")
                starts = t_stage_starts(tctx, pstate, tick)
                args, kw = tiled_operands(tctx, tcfg, starts, pstate, tick,
                                          blk)
                out = tiled.netsim_tiled(*args, **kw)
                for f in out._fields:
                    _close(f"tick {tick}: {f}", getattr(out, f)[0],
                           getattr(ref, f))
            state, _ = tick_fn(state, np.int32(tick), knobs)
        assert tiled.netsim_tiled.launches == before   # CPU: plain version
    assert int(np.asarray(ref.eff).astype(bool).sum()) > 0


# ----------------------------------------------------- whole 300-tick runs
@functools.lru_cache(maxsize=None)
def _reference_run(blk, per_step_ecmp):
    topo, wl = _small(R)
    cfg = R.SimParams(n_ticks=300, window=8, sym_on=True,
                      per_step_ecmp=per_step_ecmp, backend="pallas",
                      segsum="onehot", blk=blk)
    with jax.threefry_partitionable(False):
        res = R.simulate(topo, wl, cfg, routing="ecmp", seed=3)
        return jax.tree.map(np.asarray, res)


@functools.lru_cache(maxsize=None)
def _eager_run(per_step_ecmp):
    topo, wl = _small(T)
    cfg = T.SimParams(n_ticks=300, window=8, sym_on=True,
                      per_step_ecmp=per_step_ecmp)
    return T.simulate(topo, wl, cfg, routing="ecmp", seed=3, device="cpu")


@pytest.mark.parametrize("per_step_ecmp", [True, False],
                         ids=["ecmp", "ecmp_flow"])
@pytest.mark.parametrize("blk", BLKS)
def test_tiled_run_matches_reference_and_eager(blk, per_step_ecmp):
    ref = _reference_run(blk, per_step_ecmp)
    topo, wl = _small(T)
    cfg = T.SimParams(n_ticks=300, window=8, sym_on=True,
                      per_step_ecmp=per_step_ecmp, backend="cuda",
                      segsum="onehot", blk=blk)
    port = T.simulate(topo, wl, cfg, routing="ecmp", seed=3, device="cpu")
    eager = _eager_run(per_step_ecmp)
    for f in T.SimResult._fields:
        _close(f"blk={blk} vs reference: {f}", getattr(port, f),
               getattr(ref, f))
        _close(f"blk={blk} vs eager: {f}", getattr(port, f),
               getattr(eager, f).numpy())
    assert int(port.job_finish_ticks[0]) < T.stages.I32MAX


def test_blk_with_tick_window_runs_the_window_kernel():
    """``blk`` + ``tick_window=5`` normalizes to the window kernel: the run
    equals the scatter window run bit for bit and the reference's combined
    configuration within the contract."""
    topo, wl = _small(T)
    cfg = T.SimParams(n_ticks=300, window=8, sym_on=True, backend="cuda",
                      tick_window=5)
    both = T.simulate(topo, wl, cfg._replace(segsum="onehot", blk=16),
                      routing="ecmp", seed=3, device="cpu")
    win = T.simulate(topo, wl, cfg, routing="ecmp", seed=3, device="cpu")
    for f in T.SimResult._fields:
        assert torch.equal(getattr(both, f), getattr(win, f)), f
    rtopo, rwl = _small(R)
    rcfg = R.SimParams(n_ticks=300, window=8, sym_on=True, backend="pallas",
                       tick_window=5, segsum="onehot", blk=16)
    with jax.threefry_partitionable(False):
        ref = R.simulate(rtopo, rwl, rcfg, routing="ecmp", seed=3)
    for f in T.SimResult._fields:
        _close(f"blk + tick_window: {f}", getattr(both, f),
               getattr(ref, f))


@pytest.mark.parametrize("opt,match", [
    (dict(segsum="dense"), "segsum"),
    (dict(segsum="onehot", blk=0), "blk"),
    (dict(blk=16), "onehot"),
    (dict(blk=16, tick_window=5), "onehot")],
    ids=["unknown_segsum", "zero_blk", "blk_needs_onehot",
         "blk_needs_onehot_windowed"])
def test_structure_errors_match_reference(opt, match):
    topo, wl = _small(T)
    cfg = T.SimParams(n_ticks=20, window=8, backend="cuda", **opt)
    with pytest.raises(ValueError, match=match):
        T.simulate(topo, wl, cfg, routing="ecmp", seed=0, device="cpu")
    # the reference raises ValueError for the same tiling plans
    if "blk" in opt and opt.get("segsum") != "onehot":
        rtopo, rwl = _small(R)
        rcfg = R.SimParams(n_ticks=20, window=8, backend="pallas", **opt)
        with pytest.raises(ValueError, match=match):
            R.simulate(rtopo, rwl, rcfg, routing="ecmp", seed=0)


# --------------------------------------------- the hot scratch's split
# (hosts, F, L+1, DJ) of the fat_tree_multipod grid at window 64, H = 6,
# one job: the port's own builders give these dimensions
FABRICS = {128: (128, 449, 17), 256: (256, 897, 33), 512: (512, 1793, 65)}


@pytest.mark.parametrize("hosts", list(FABRICS))
def test_hot_scratch_split(hosts):
    F, L1, DJ = FABRICS[hosts]
    FW, H, J = F * 64, 6, 1
    # link, job and Symphony rows, the row sorts' counts and offsets, two
    # ints per warp; link ids and the row-sorted entry list (uint16 each)
    # and a flag byte per instance; the uint16 active-instance list
    rows = 4 * (8 * L1 + J + 4 * DJ + 2 + 2 * 16)
    ids = 2 * FW * H + 2 * FW * H + FW
    act = 2 * FW

    def r16(n):
        return n + -n % 16

    tick = K.hot_smem_split(FW, H, L1, J, DJ)
    win = Wn.window_smem_split(F, FW, H, L1, J, DJ)
    if hosts == 128:
        # everything fits: the ids and list follow the rows in shared
        # memory; the global workspace holds the active list alone
        assert tick == (r16(rows + ids), 0, r16(act)) and win.ids == 0
        assert win.ws == r16(act)
        assert win.smem <= K.SMEM_LIMIT
    else:
        # the ids and list move to the per-lane global workspace, after the
        # active list; the rows stay
        assert tick == (r16(rows), r16(ids), r16(act) + r16(ids))
        assert win.ids == r16(ids) and win.ws == tick.ws
        assert rows < win.smem <= K.SMEM_LIMIT
        assert rows + ids > K.SMEM_LIMIT
    assert tiled.tiled_smem_bytes(L1, J, DJ) <= K.SMEM_LIMIT


def _c_functions(src: str) -> dict:
    """The ``inline size_t`` byte formulas of a CUDA source as Python
    functions (integer C arithmetic: ``/`` floors on these non-negative
    sizes, ``c ? a : b`` on a bare name)."""
    import re
    defs = {}
    for name, params, body in re.findall(
            r"inline size_t (\w+)\(([^)]*)\)\s*\{(.*?)\n\}", src, re.S):
        args = [p.split()[-1] for p in params.split(",")]
        py = []
        for stmt in body.split(";"):
            stmt = " ".join(stmt.split())
            if not stmt:
                continue
            stmt = stmt.replace("(size_t)", "").replace("const size_t ", "")
            stmt = re.sub(r"(?<!/)/(?!/)", "//", stmt)
            # c ? a : b -> (a if c else b), the branches balanced in parens
            while "?" in stmt:
                q = stmt.index("?")
                cond = re.search(r"(\w+)\s*$", stmt[:q])
                depth, k = 0, q + 1
                while not (depth == 0 and stmt[k] == ":"):
                    depth += {"(": 1, ")": -1}.get(stmt[k], 0)
                    k += 1
                depth, e = 0, k + 1
                while e < len(stmt) and not (depth == 0 and stmt[e] in ");,"):
                    depth += {"(": 1, ")": -1}.get(stmt[e], 0)
                    e += 1
                stmt = (stmt[:cond.start(1)] + f"({stmt[q + 1:k]} if "
                        f"{cond.group(1)} else {stmt[k + 1:e]})" + stmt[e:])
            py.append(stmt)
        defs[name] = (args, py)
    return defs


def _compile(defs: dict, consts: dict) -> dict:
    ns = dict(consts)
    for name, (args, stmts) in defs.items():
        code = f"def {name}({', '.join(args)}):\n" + "".join(
            f"    {st}\n" for st in stmts)
        exec(code, ns)
    return ns


def test_scratch_split_matches_the_cuda_source():
    """hot_smem_split and window_smem_split compute what the byte formulas
    of csrc/netsim_hot.cuh and csrc/netsim_window.cu compute (the sources'
    own expressions, evaluated), for the three multipod sizes, Table 1 and
    odd sizes; the thread count is the header's."""
    import re
    hot = (K.CSRC / "netsim_hot.cuh").read_text()
    win = (K.CSRC / "netsim_window.cu").read_text()
    threads = int(re.search(r"#define NT_THREADS (\d+)", hot).group(1))
    assert threads == K.THREADS and "#define NT_WARPS (NT_THREADS / 32)" in hot
    ns = _compile({**_c_functions(hot), **_c_functions(win)},
                  {"NT_WARPS": threads // 32})
    for name in ("round16", "hot_rows_bytes", "hot_ids_raw", "hot_act_bytes",
                 "hot_ws_bytes", "hot_smem_bytes", "win_rows_bytes",
                 "win_smem_bytes"):
        assert name in ns, name
    dims = [(F, F * 64, 6, L1, 1, DJ) for F, L1, DJ in FABRICS.values()]
    dims += [(32, 2048, 4, 97, 1, 5), (3, 15, 3, 11, 2, 6),
             (5, 35, 5, 21, 3, 12)]
    for F, FW, H, L1, J, DJ in dims:
        for split, smem_fn in (
                (K.hot_smem_split(FW, H, L1, J, DJ),
                 lambda f: ns["hot_smem_bytes"](FW, H, L1, J, DJ, f)),
                (Wn.window_smem_split(F, FW, H, L1, J, DJ),
                 lambda f: ns["win_smem_bytes"](F, FW, H, L1, J, DJ, f))):
            in_smem = int(split.ids == 0)
            assert split.smem == smem_fn(in_smem)
            assert split.ws == ns["hot_ws_bytes"](FW, H, in_smem)
            assert split.ids == (0 if in_smem else
                                 ns["round16"](ns["hot_ids_raw"](FW, H)))
            # the ids leave shared memory only when they do not fit there
            assert (smem_fn(1) <= K.SMEM_LIMIT) == bool(in_smem)


def test_tiled_smem_and_interface_match_the_cuda_source():
    """tiled_smem_bytes computes what the source's sweep formulas give
    (the larger of sweep 0's and sweep 2's), at the three multipod sizes,
    Table 1 and odd sizes; the wrapper's pointer count and interface tag
    are the source's; no float atomics."""
    import re
    src = (K.CSRC / "netsim_tiled.cu").read_text()
    hot = (K.CSRC / "netsim_hot.cuh").read_text()
    threads = int(re.search(r"#define NT_THREADS (\d+)", hot).group(1))
    ns = _compile(_c_functions(src), {"NT_WARPS": threads // 32})
    dims = [(L1, 1, DJ) for _, L1, DJ in FABRICS.values()]
    dims += [(97, 4, 20), (11, 2, 6), (21, 3, 12)]
    for L1, J, DJ in dims:
        assert tiled.tiled_smem_bytes(L1, J, DJ) == max(
            ns["tiled_smem0"](L1, J, DJ), ns["tiled_smem2"](L1))
    assert int(re.search(r"#define N_TILED_PTRS (\d+)", src).group(1)) == \
        tiled._N_PTRS
    assert re.search(r"netsim_tiled_abi\(\) \{ return (\d+); \}",
                     src).group(1) == str(tiled.ABI)
    assert not re.search(r"atomic\w+\(&?\w*(sp|shi|slo|cnt|psn|f)\b", src)
    assert set(re.findall(r"atomic(\w+)\(&(\w+)", src)) == {
        ("Add", "lcur_s"), ("Add", "scur_s"), ("Min", "jobmin_s")}


def test_split_raises_when_the_rows_alone_do_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        K.hot_smem_split(64, 6, 10_000, 1, 17)


def test_dims_of_the_512_host_grid():
    """The dimensions the split test assumes are the builders'."""
    topo = T.make_fat_tree(16, 4, 4, 8, 8, core_oversubscription=2.0)
    b = T.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(512)), ring_size=32, chunk_bytes=8e6,
                   passes=1, barrier=False)
    cfg = T.SimParams(n_ticks=20, window=64, dt=20e-6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ctx, _, _ = T.make_lanes(topo, b.build(), cfg.structure(),
                                 cfg.knobs(), seeds=[0], device="cpu")
    assert (ctx.F, ctx.L + 1, ctx.DJ, ctx.H, ctx.J) == \
        (512, 1793, 65, 6, 1)


# ----------------------- the kernel's per-block sorted folds, modelled
def _sorted_fold_partials(rows, vals, active, blk, H, R, reverse=False):
    """The kernel's per-block partials in numpy: per (lane, block), the
    active instances in ascending order, each row's entries counted, the
    counts scanned into offsets, the entries placed in batches of 32 in
    (instance, hop) order (an entry's slot: its row's cursor plus the
    entries of the same row before it in the batch; then the cursors
    advance), and each row's segment added in order from zero, float32
    (``reverse``: from its end, a misordered fold)."""
    B, E = rows.shape
    FW = E // H
    NB = -(-FW // blk)
    out = np.zeros((B, NB, R), np.float32)
    for b in range(B):
        for nb in range(NB):
            i0, i1 = nb * blk, min((nb + 1) * blk, FW)
            ents = [(i - i0) * H + h for i in range(i0, i1) if active[b, i]
                    for h in range(H)]
            key = rows[b, i0 * H:i1 * H]
            val = vals[b, i0 * H:i1 * H]
            cnt = np.bincount([key[e] for e in ents], minlength=R)
            off = np.concatenate([[0], np.cumsum(cnt)])
            cur = off[:-1].copy()
            lst = np.empty(len(ents), np.int64)
            for e0 in range(0, len(ents), 32):
                batch = [key[e] for e in ents[e0:e0 + 32]]
                for lane, e in enumerate(ents[e0:e0 + 32]):
                    lst[cur[key[e]] + batch[:lane].count(key[e])] = e
                for k in set(batch):
                    cur[k] += batch.count(k)
            for r in range(R):
                acc = np.float32(0.0)
                seg = range(off[r], off[r + 1])
                for p in (reversed(seg) if reverse else seg):
                    acc = np.float32(acc + val[lst[p]])
                out[b, nb, r] = acc
    return out


@pytest.mark.parametrize("routing", ["ecmp", "ecmp_flow"])
@pytest.mark.parametrize("blk", [4, 64])
def test_sorted_folds_model_equals_plain_partials(blk, routing):
    """The kernel's design (per-block stable counting sort by row, one
    ordered fold per row segment, inactive entries left out) gives the
    plain version's per-block partials of the link loads (proportional,
    hi, lo) and the Symphony cnt/cntop rows bit for bit, on mid-run states
    of the 8-host leaf-spine (sym_on/pq_on lanes; 8 of the 64 instances
    active a lane).  blk 4 (16 blocks) has blocks with no active instance
    and rows that only one block touches; at blk 64 (one block) with
    per-step ECMP, folding each segment from its end parts from the plain
    partials, so the check sees the order."""
    from repro_torch.core.netsim.stages import engine_tick_eager
    topo, wl = _small(T)
    cfg = T.SimParams(n_ticks=100, window=8, sym_win_ticks=5,
                      backend="cuda", segsum="onehot", blk=blk,
                      per_step_ecmp=routing == "ecmp")
    knobs = T.stack_knobs([cfg.knobs(), cfg._replace(sym_on=True).knobs(),
                           cfg._replace(pq_on=True).knobs()])
    ctx, ecfg, sim = T.make_lanes(topo, wl, cfg.structure(), knobs,
                                  seeds=[3], routing=routing, device="cpu")
    state = sim.engine
    empty_blocks = lone_rows = checked = misordered = 0
    with torch.no_grad():
        for tick in range(WARM + CHECK):
            if tick >= WARM:
                starts = t_stage_starts(ctx, state, tick)
                args, kw = tiled_operands(ctx, ecfg, starts, state, tick,
                                          blk)
                got = {}
                tiled.tiled_tick_ref(*args, **kw, partials=got)
                active = got["active"].numpy()
                H = ctx.H
                for name in ("link_p", "link_hi", "link_lo", "cnt",
                             "cntop"):
                    rows, vals, part = (x.numpy() for x in got[name])
                    R = part.shape[2]
                    model = _sorted_fold_partials(rows, vals, active, blk,
                                                  H, R)
                    assert np.array_equal(model.view(np.int32),
                                          part.view(np.int32)), \
                        f"tick {tick}: {name}"
                    checked += 1
                    misordered += int((_sorted_fold_partials(
                        rows, vals, active, blk, H, R, reverse=True
                    ).view(np.int32) != part.view(np.int32)).sum())
                # coverage: blocks with no active instance; rows whose
                # active entries lie in one block only
                per_block = active.reshape(active.shape[0], -1, blk)
                empty_blocks += int((~per_block.any(2)).sum())
                rows = got["link_p"][0].numpy().reshape(
                    active.shape[0], -1, blk * H)
                act_e = np.repeat(per_block, H, axis=2)
                for b in range(rows.shape[0]):
                    seen = {}
                    for nb in range(rows.shape[1]):
                        for r in set(rows[b, nb][act_e[b, nb]].tolist()):
                            seen[r] = seen.get(r, 0) + 1
                    lone_rows += sum(1 for c in seen.values() if c == 1)
            state, _ = engine_tick_eager(ctx, ecfg, state, tick, False)
    assert checked == 5 * CHECK
    if blk == 4:
        assert empty_blocks > 0 and lone_rows > 0
    if blk == 64 and routing == "ecmp":
        assert misordered > 0


# ------------------------------------------------------- the wrapper
def _operands(blk=16):
    topo, wl = _small(T)
    cfg = T.SimParams(n_ticks=20, window=8, backend="cuda", segsum="onehot",
                      blk=blk)
    ctx, ecfg, sim = T.make_lanes(topo, wl, cfg.structure(),
                                  T.stack_knobs([cfg.knobs()] * 2),
                                  seeds=[0], device="cpu")
    starts = t_stage_starts(ctx, sim.engine, 0)
    return tiled_operands(ctx, ecfg, starts, sim.engine, 0, blk)


def test_cpu_wrapper_runs_plain_version_without_launching():
    args, kw = _operands()
    before = tiled.netsim_tiled.launches
    out = tiled.netsim_tiled(*args, **kw)
    ref = tiled.tiled_tick_ref(*args, **kw)
    assert tiled.netsim_tiled.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["dtype", "shape", "table", "policy",
                                  "blk", "device_mix"])
def test_wrapper_rejects_bad_operands(case):
    args, kw = _operands()
    args = list(args)
    err = ValueError
    if case == "dtype":
        args[0] = args[0].to(torch.int64)            # step must be int32
        err = TypeError
    elif case == "shape":
        args[4] = args[4][:, :-1].contiguous()       # q_prev one link short
    elif case == "table":
        args[19] = args[19]._replace(n_paths=args[19].n_paths[:, :-1])
    elif case == "policy":
        kw = dict(kw, policy="wfq")
    elif case == "blk":
        kw = dict(kw, blk=0)
    else:
        args[2] = args[2].to("meta")                 # rate on another device
    with pytest.raises(err):
        tiled.netsim_tiled(*args, **kw)
