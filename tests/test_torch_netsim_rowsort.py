"""The tick and window kernels' row sort, emulated on the CPU.

``csrc/netsim_hot.cuh`` adds every float sum of a tick (offered load per
link row, Symphony ``cnt``/``cntop`` per (domain, job) row) over a list of
the tick's active (instance, hop) entries sorted by row.  The list comes
from a stable counting sort that one warp runs: the active instances in
ascending order, their entries visited in ascending flat (instance, hop)
order in batches of 32, each entry placed at its row's cursor plus its
rank among the batch's entries of the same row (``__match_any_sync`` and
``__popc(peers & lanemask_lt)``), after which the lowest lane of each row
advances the row's cursor by the batch's count.  The warp steps its
(instance, hop) index by 32 entries a batch without a division.

:func:`place` is that placement in numpy, step for step.  The tests hold it
against ``np.argsort(kind="stable")`` (a hypothesis property and the edge
cases: no active instance, every instance active, every entry in one row,
paths mostly padded with the null link), and hold the kernel's sequential
per-row folds over its lists against ``stages.ordered_segment_sum`` and
the reference's ``.at[].add`` bit for bit, on the entries of mid-run
states (Table 1, and the 128-host fat_tree_multipod grid the kernels run
at full size on the card).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("hypothesis")
import hypothesis.strategies as st  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402

import repro_torch.core.netsim as T  # noqa: E402
from repro_torch.core.netsim.stages import (div_scalar,  # noqa: E402
                                            engine_tick_eager,
                                            ordered_segment_sum,
                                            stage_starts)
from repro_torch.kernels.netsim_tick import ref as Rf  # noqa: E402
from repro_torch.kernels.netsim_tick.ops import tick_operands  # noqa: E402

WARP = 32


def place(act: np.ndarray, keys: np.ndarray, n_rows: int):
    """The kernel's stable placement of the ``len(act) * H`` entries whose
    rows are ``keys`` ([A, H]).  Returns ``(entry list, row offsets)``: the
    instance of each placed entry and offsets ``[n_rows + 1]``."""
    A, H = keys.shape
    counts = np.bincount(keys.reshape(-1), minlength=n_rows)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    cur = off[:-1].copy()
    out = np.full(A * H, -1, np.int64)
    lane = np.arange(WARP)
    q, hh = lane // H, lane % H
    dq, dh = WARP // H, WARP - (WARP // H) * H
    for _ in range(0, A * H, WARP):
        ok = q < A
        qi = np.minimum(q, A - 1)
        key = np.where(ok, keys[qi, hh], -1)
        inst = np.where(ok, act[qi], 0)
        for j in range(WARP):                       # each lane, in lockstep
            if not ok[j]:
                continue
            peers = key == key[j]
            rank = int(peers[:j].sum())
            out[cur[key[j]] + rank] = inst[j]
        for k in np.unique(key[ok]):                # leaders advance
            cur[k] += int((key[ok] == k).sum())
        q, hh = q + dq, hh + dh
        q, hh = np.where(hh >= H, q + 1, q), np.where(hh >= H, hh - H, hh)
    assert (cur == off[1:]).all()
    return out, off


def stable_reference(act, keys):
    """The same list from a stable argsort of the flat entry keys."""
    H = keys.shape[1]
    order = np.argsort(keys.reshape(-1), kind="stable")
    return np.asarray(act, np.int64)[order // H] if len(order) else \
        np.zeros(0, np.int64)


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 70), st.integers(1, 40), st.integers(1, 50),
       st.integers(0, 2**31 - 1))
def test_placement_is_a_stable_sort(A, H, rows, seed):
    """Random rows for A active instances of H hops (H above 32 too, where
    a batch holds less than one instance)."""
    rng = np.random.default_rng(seed)
    act = np.sort(rng.choice(4096, size=A, replace=False))
    keys = rng.integers(0, rows, size=(A, H))
    got, off = place(act, keys, rows)
    want = stable_reference(act, keys)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.diff(off), np.bincount(keys.reshape(-1), minlength=rows))


@pytest.mark.parametrize("case", ["no_active", "all_active", "one_row",
                                  "null_link_hops"])
def test_placement_edge_cases(case):
    rng = np.random.default_rng(5)
    FW, H, L1 = 2048, 6, 97
    null = L1 - 1
    if case == "no_active":
        act = np.zeros(0, np.int64)
        keys = np.zeros((0, H), np.int64)
    elif case == "all_active":
        act = np.arange(FW)
        keys = rng.integers(0, L1, size=(FW, H))
    elif case == "one_row":
        act = np.sort(rng.choice(FW, 300, replace=False))
        keys = np.full((300, H), 7)
    else:
        # paths of 2 links padded with the null link, so that hops of one
        # instance share a row and the null row holds most entries
        act = np.sort(rng.choice(FW, 500, replace=False))
        keys = np.full((500, H), null)
        keys[:, :2] = rng.integers(0, null, size=(500, 2))
    got, off = place(act, keys, L1)
    np.testing.assert_array_equal(got, stable_reference(act, keys))
    assert off[-1] == len(act) * H
    if case == "null_link_hops":
        seg = got[off[null]:off[null + 1]]
        # each instance's null hops sit together, instances ascending
        np.testing.assert_array_equal(seg, np.repeat(act, H - 2))


def fold(lst, off, vals, base):
    """The kernel's per-row sums: base[r] then each entry of the row's
    segment added in list order, in float32."""
    out = np.asarray(base, np.float32).copy()
    for r in range(len(off) - 1):
        acc = out[r]
        for i in lst[off[r]:off[r + 1]]:
            acc = np.float32(acc + vals[i])
        out[r] = acc
    return out


def multipod128():
    """benchmarks/grid512.py's configuration at 128 hosts (4 pods)."""
    topo = T.make_fat_tree(4, 4, 4, 8, 8, core_oversubscription=2.0)
    b = T.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(128)), ring_size=32, chunk_bytes=8e6,
                   passes=1, barrier=False)
    return topo, b.build(), T.SimParams(n_ticks=300, window=64, dt=20e-6,
                                        sym_win_ticks=5, cc_epoch_ticks=2)


def table1():
    topo = T.make_leaf_spine(32, 4, 4)
    b = T.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(32)), ring_size=8, chunk_bytes=1e6,
                   passes=2, barrier=False)
    return topo, b.build(), T.SimParams(n_ticks=300, window=64)


@pytest.fixture(scope="module", params=[("table1", 300), ("multipod128", 200)],
                ids=["table1", "multipod128"])
def mid_run(request):
    """A mid-run tick's operands and the plain tick's outputs (sym_on, pq_on
    and per-step ECMP on, so that both share policies' sums are live)."""
    name, warm = request.param
    topo, wl, cfg = {"table1": table1, "multipod128": multipod128}[name]()
    cfg = cfg._replace(sym_on=True, pq_on=True, per_step_ecmp=True)
    ctx, ecfg, sim = T.make_lanes(topo, wl, cfg.structure(), cfg.knobs(),
                                  seeds=[3], device="cpu")
    state = sim.engine
    with torch.no_grad():
        for tick in range(warm):
            state, _ = engine_tick_eager(ctx, ecfg, state, tick, False)
        starts = stage_starts(ctx, state, warm)
        args, kw = tick_operands(ctx, ecfg, starts, state, warm)
        out = Rf.hot_tick(*args, **kw)
    return ctx, args, kw, out


def entries(ctx, args, out):
    """Lane 0's active mask, link rows [FW, H] and Symphony rows [FW, H]."""
    step, sent, _, done_upto = (a[0] for a in args[:4])
    job, flow = ctx.inst_job.long(), ctx.inst_flow.long()
    sched = ctx.wl.chunk_sched
    iseg = torch.div(step, ctx.sps_i, rounding_mode="floor") * ctx.nph_i + \
        ctx.phase_i
    chunk = sched[job, iseg.clamp(0, sched.shape[1] - 1)]
    active = (step >= 0) & (sent < chunk) & ~(step < done_upto[flow])
    links = out.iroute[0].long()
    dj = ctx.st.link_dom[0][links].long() * ctx.J + job[:, None]
    return active.numpy(), links.numpy(), dj.numpy()


def test_mid_run_link_sums_equal_the_ordered_scatter(mid_run):
    """Offered load per link (all, strict-priority, low class): the folds
    over the emulated list equal ordered_segment_sum and the reference's
    scatter-add bit for bit."""
    ctx, args, kw, out = mid_run
    active, links, _ = entries(ctx, args, out)
    act = np.flatnonzero(active)
    L1 = ctx.L + 1
    lst, off = place(act, links[act], L1)
    # rows that hold entries of several instances, whose order matters
    assert len(act) and np.diff(off).max() > 1
    rate = args[2][0].numpy()
    w_rate = np.where(active, rate, np.float32(0))
    zero = np.zeros(L1, np.float32)
    got = fold(lst, off, w_rate, zero)
    flat = torch.from_numpy(links.reshape(1, -1))
    vals = torch.from_numpy(np.repeat(w_rate, links.shape[1])[None])
    want = ordered_segment_sum(torch.zeros(1, L1), flat, vals)[0]
    assert torch.equal(torch.from_numpy(got), want)
    ref = np.asarray(jnp.zeros(L1, jnp.float32).at[links.reshape(-1)].add(
        np.repeat(w_rate, links.shape[1])))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    # the two classes: the kernel splits one walk by each entry's class
    job = ctx.inst_job.numpy()
    wire = (np.floor_divide(args[0][0].numpy(), ctx.sps_i.numpy())
            * ctx.nph_i.numpy() + ctx.phase_i.numpy()) * 4096 + \
        np.mod(args[0][0].numpy(), ctx.sps_i.numpy()) + ctx.off_i.numpy()
    jmin = np.full(ctx.J, 2**30)
    np.minimum.at(jmin, job[active], wire[active])
    hi = active & (wire <= jmin[job])
    for cls in (hi, active & ~hi):
        v = np.where(cls, rate, np.float32(0))
        got_c = fold(lst, off, v, zero)
        want_c = ordered_segment_sum(
            torch.zeros(1, L1), flat,
            torch.from_numpy(np.repeat(v, links.shape[1])[None]))[0]
        assert torch.equal(torch.from_numpy(got_c), want_c)


def test_mid_run_symphony_sums_equal_the_ordered_scatter(mid_run):
    """Symphony cnt per (domain, job) row from its input value: the fold
    over the emulated list equals ordered_segment_sum bit for bit, and so
    does cntop (the entries above the row's step-min)."""
    ctx, args, kw, out = mid_run
    active, links, dj = entries(ctx, args, out)
    act = np.flatnonzero(active)
    DJ = ctx.DJ
    lst, off = place(act, dj[act], DJ)
    assert np.diff(off).max() > 1
    eff = out.eff[0].numpy()
    pkts = div_scalar(torch.from_numpy(eff) * kw["dt"], kw["mtu"]).numpy()
    pk_act = np.where(active, pkts, np.float32(0))
    s_cnt = args[8][0].numpy()
    got = fold(lst, off, pk_act, s_cnt)
    flat = torch.from_numpy(dj.reshape(1, -1))
    want = ordered_segment_sum(
        torch.from_numpy(s_cnt[None]), flat,
        torch.from_numpy(np.repeat(pk_act, dj.shape[1])[None]))[0]
    assert torch.equal(torch.from_numpy(got), want)
    smin = args[5][0].numpy()
    wire = (np.floor_divide(args[0][0].numpy(), ctx.sps_i.numpy())
            * ctx.nph_i.numpy() + ctx.phase_i.numpy()) * 4096 + \
        np.mod(args[0][0].numpy(), ctx.sps_i.numpy()) + ctx.off_i.numpy()
    s_cntop = args[9][0].numpy()
    # cntop adds an entry's packets where its wire step is above the
    # pre-update step-min of the entry's own row
    over = wire[:, None] > smin[dj]
    got_op = s_cntop.copy()
    for r in range(DJ):
        acc = got_op[r]
        for p in range(off[r], off[r + 1]):
            i = lst[p]
            h = np.flatnonzero(dj[i] == r)
            # the segment holds instance i once per hop in row r
            if over[i, h[0]]:
                acc = np.float32(acc + pk_act[i])
        got_op[r] = acc
    want_op = ordered_segment_sum(
        torch.from_numpy(s_cntop[None]), flat,
        torch.from_numpy(np.where(over, pk_act[:, None], np.float32(0))
                         .reshape(1, -1)))[0]
    assert torch.equal(torch.from_numpy(got_op), want_op)
