"""The port's Alg. 1 switch pipeline against the JAX package.

``kernel.switch_pipeline`` on CPU tensors runs the CUDA kernel's plain
version (``ref.pipeline_plain``).  It is held against the reference's
``switch_pipeline`` (the Pallas kernel in interpret mode) and against the
oracles over ``core/symphony.py`` (the reference's ``pipeline_ref`` and the
port's), on the packet traces of ``tests/test_kernels.py`` (3,000 and
8,000 packets) and on a 1,000-packet trace (not a multiple of the
reference's 256-packet blocks), on both marking paths.

The CUDA kernel computes the walk as a parallel scan (three block scans
with decoupled look-backs over tiles); ``ScanModel`` below is a numpy model
of that design (its map families and composition rules, tiles of 64
packets as 8 threads x 8 items in warps of 4, look-backs over windows of
4 predecessors that meet each either as an aggregate or as an inclusive
state), held bit for
bit against ``pipeline_plain`` and the reference kernel on
``ref.scan_traces(64)``, whose edge cases sit on tile edges.

Contract: ``exact=True`` equals the reference kernel bit for bit, and its
marks and state equal the oracles'.  ``exact=False`` (the log2 LUT path)
has the same exact state trajectory; its marks equal the reference
kernel's except where the platform's ``log2`` rounds differently just
below a power of two and flips a LUT index — on these traces that happens
for no packet (asserted: 0 differing marks) — and its mark rate stays
within the reference's own bound of the exact rate
(``test_switch_pipeline_lut_close``).  The CUDA kernel itself is held
against this plain version on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.core.symphony import SymphonyParams as RSymphonyParams  # noqa: E402,E501
from repro.kernels.switch_pipeline.kernel import switch_pipeline as r_sp  # noqa: E402,E501
from repro.kernels.switch_pipeline.ref import pipeline_ref as r_oracle  # noqa: E402,E501

from repro_torch.kernels.switch_pipeline import kernel as SK  # noqa: E402
from repro_torch.kernels.switch_pipeline import ref as SR  # noqa: E402

# (packets, seed, steps advance every `div` packets, step jitter `hi`)
TRACES = {"3000": (3000, 42, 300, 6), "8000": (8000, 7, 200, 4),
          "1000": (1000, 3, 100, 5)}


def _trace(name):
    n, seed, div, hi = TRACES[name]
    rng = np.random.default_rng(seed)
    steps = np.maximum(0, rng.integers(0, hi, n) + np.arange(n) // div)
    psns = rng.integers(1, 5000, n)
    lasts = rng.random(n) < 0.02
    wins = np.arange(n) % 100 == 99
    us = rng.random(n)
    return (steps.astype(np.int32), psns.astype(np.float32),
            lasts.astype(np.int32), wins.astype(np.int32),
            us.astype(np.float32))


def _port(arrays, **kw):
    out = SK.switch_pipeline(*(torch.from_numpy(a) for a in arrays), **kw)
    return [x.numpy() for x in out]


def _reference(arrays, **kw):
    out = r_sp(*(jnp.asarray(a) for a in arrays), **kw)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("trace", list(TRACES))
def test_exact_path_bitwise_vs_reference_kernel_and_oracles(trace):
    arrays = _trace(trace)
    port = _port(arrays, exact=True)
    ref = _reference(arrays, exact=True)
    for name, a, b in zip(("marks", "step_min", "psn_rec", "alpha"), port,
                          ref):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    oracle = [np.asarray(x) for x in
              r_oracle(*(jnp.asarray(a) for a in arrays), RSymphonyParams())]
    mine = [x.numpy() for x in SR.pipeline_ref(
        *(torch.from_numpy(a) for a in arrays))]
    for o in (oracle, mine):
        assert np.array_equal(port[0], o[0])            # marks
        assert np.array_equal(port[1], o[1])            # step_min
        np.testing.assert_array_equal(port[2], o[2])    # psn_rec
        np.testing.assert_array_equal(port[3], o[3])    # alpha
    assert 0 < port[0].sum() < len(port[0])


@pytest.mark.parametrize("trace", list(TRACES))
def test_lut_path_vs_reference_kernel(trace):
    arrays = _trace(trace)
    lut = _port(arrays, exact=False)
    exact = _port(arrays, exact=True)
    ref = _reference(arrays, exact=False)
    # the state trajectory is exact whatever the marking path
    for a, b, c in zip(lut[1:], exact[1:], ref[1:]):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    n_diff = int((lut[0] != ref[0]).sum())
    assert n_diff == 0, f"{n_diff} LUT marks differ from the reference"
    re, rl = float(exact[0].mean()), float(lut[0].mean())
    assert abs(re - rl) < 0.02 + 0.25 * re


def test_lut_log2_matches_reference_on_integers_and_powers_of_two():
    """The LUT value of every psn the traces can carry (1..4999), of the
    alpha values (1..64) and of k equals the reference's."""
    from repro.kernels.switch_pipeline.kernel import _LOG2_LUT, _lut_log2
    x = np.concatenate([np.arange(1, 5000), [0.01]]).astype(np.float32)
    mine = SR.lut_log2(torch.from_numpy(x),
                       torch.from_numpy(SR.LOG2_LUT)).numpy()
    ref = np.asarray(_lut_log2(jnp.asarray(x), jnp.asarray(_LOG2_LUT)))
    assert np.array_equal(SR.LOG2_LUT, _LOG2_LUT)
    assert np.array_equal(mine, ref)


def test_kernel_lut_constants_equal_the_plain_lut():
    """The CUDA source's LUT literals are LOG2_LUT bit for bit."""
    import re
    from pathlib import Path
    src = (Path(SK.__file__).parent / "csrc" / "switch_pipeline.cu"
           ).read_text()
    body = src[src.index("LOG2_LUT[16] = {"):].split("}", 1)[0]
    lits = re.findall(r"(0x[0-9a-f.]+p[+-]?\d+)f", body)
    consts = np.array([float.fromhex(x) for x in lits], np.float32)
    assert len(consts) == 16
    assert np.array_equal(consts, SR.LOG2_LUT)


def test_kernel_constants_and_interface_match_the_source():
    """The wrapper's tile and interface tag are the source's; the launch
    takes the arguments the binding declares; no float value goes through
    an atomic (the only atomic takes the tile counter)."""
    import ctypes
    import re
    from pathlib import Path
    src = (Path(SK.__file__).parent / "csrc" / "switch_pipeline.cu"
           ).read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"#define (SP_THREADS|SP_ITEMS) (\d+)", src)}
    assert consts["SP_THREADS"] * consts["SP_ITEMS"] == SK.TILE
    assert re.search(r"switch_pipeline_abi\(\) \{ return (\d+); \}",
                     src).group(1) == str(SK.ABI)
    sig = src[src.index('extern "C" int switch_pipeline_launch('):]
    sig = sig[:sig.index(")")]
    lib = type("Lib", (), {})()
    for name in ("switch_pipeline_launch", "switch_pipeline_ws_bytes",
                 "switch_pipeline_abi"):
        setattr(lib, name, type("Fn", (), {})())
    SK._bind(lib)
    assert len(lib.switch_pipeline_launch.argtypes) == sig.count(",") + 1
    assert lib.switch_pipeline_launch.argtypes[9] is ctypes.c_void_p  # ws
    assert re.findall(r"atomic\w+\(", src) == ["atomicAdd("]
    assert "atomicAdd(a.counter, 1)" in src


def test_state_starts_fresh_on_every_call():
    arrays = _trace("1000")
    first = _port(arrays)
    again = _port(arrays)
    for a, b in zip(first, again):
        assert np.array_equal(a, b)
    assert first[3][0] == 1.0                       # alpha(0) = 1


def test_cpu_wrapper_runs_plain_version_without_launching():
    arrays = [torch.from_numpy(a) for a in _trace("1000")]
    before = SK.switch_pipeline.launches
    out = SK.switch_pipeline(*arrays, exact=False)
    plain = SR.pipeline_plain(*arrays, exact=False)
    assert SK.switch_pipeline.launches == before
    for a, b in zip(out, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["dtype", "shape", "rank", "contiguity",
                                  "device_mix"])
def test_wrapper_rejects_bad_operands(case):
    arrays = [torch.from_numpy(a) for a in _trace("1000")]
    err = ValueError
    if case == "dtype":
        arrays[1] = arrays[1].to(torch.float64)
        err = TypeError
    elif case == "shape":
        arrays[4] = arrays[4][:-1]
    elif case == "rank":
        arrays = [a[None] for a in arrays]
    elif case == "contiguity":
        arrays[2] = torch.stack([arrays[2], arrays[2]], 1)[:, 0]
    else:
        arrays[3] = arrays[3].to("meta")
    with pytest.raises(err):
        SK.switch_pipeline(*arrays)


# ------------------------------------------- the kernel's scan, modelled
F32 = np.float32
INF = F32(np.inf)
SAT = 1 << 24            # where a float32 count stops growing (SP_SAT)


def _min_compose(f, g):              # step_min: (c, v): c ? v : min(s, v)
    return (f[0] | g[0], g[1] if g[0] else min(f[1], g[1]))


def _min_apply(m, s):
    return m[1] if m[0] else min(s, m[1])


def _sat(n):
    return min(n, SAT)


def _pc_compose(f, g):   # psn_rec (rc, rv) and counts (reset, cn, cno)
    return (f[0] | g[0], g[1] if g[0] else max(f[1], g[1]), f[2] | g[2],
            g[3] if g[2] else _sat(f[3] + g[3]),
            g[4] if g[2] else _sat(f[4] + g[4]))


def _pc_apply(m, x):
    r, n, no = x
    return (m[1] if m[0] else max(r, m[1]), m[3] if m[2] else _sat(n + m[3]),
            m[4] if m[2] else _sat(no + m[4]))


def _clampf(v, lo, hi):
    return min(max(v, lo), hi)


def _clamp_compose(f, g):            # alpha: (d, lo, hi)
    gd = F32(g[0])
    return (f[0] + g[0], _clampf(F32(f[1] + gd), g[1], g[2]),
            _clampf(F32(f[2] + gd), g[1], g[2]))


def _clamp_apply(m, a):
    return _clampf(F32(a + F32(m[0])), m[1], m[2])


MIN_ID = (0, INF)
PC_ID = (0, -INF, 0, 0, 0)
CLAMP_ID = (0, -INF, INF)


class ScanModel:
    """The kernel's scan in numpy float32 scalars: tiles of ``threads x
    items`` packets; in a tile each thread composes its items' maps, a
    two-level block scan (shuffle-style doubling within warps of ``warp``
    threads, then the warps' totals) gives each thread its exclusive
    prefix, and a look-back over the tiles before gives the tile's
    entering state: windows of ``warp`` predecessors, nearest first, each
    reduced by a shuffle-down tree up to the nearest inclusive state.
    ``rng`` decides, per predecessor read, whether it is met as an
    inclusive state or only as its aggregate (tile 0: always inclusive)."""

    def __init__(self, threads=8, items=8, warp=4, seed=0, skip=False):
        self.threads, self.items, self.warp = threads, items, warp
        self.tile = threads * items
        self.rng = np.random.default_rng(seed)
        self.skip = skip    # the planted fault: skip the nearest tile

    def block_exclusive(self, maps, compose, ident):
        w = self.warp
        incl = list(maps)
        for base in range(0, len(maps), w):
            o = 1
            while o < w:
                prev = incl[base:base + w]
                for lane in range(o, w):
                    incl[base + lane] = compose(prev[lane - o],
                                                prev[lane])
                o *= 2
        ex, total = [], ident
        for base in range(0, len(maps), w):
            pre = total
            for lane in range(w):
                ex.append(compose(pre, incl[base + lane - 1]) if lane
                          else pre)
            total = compose(total, incl[base + w - 1])
        return ex, total

    def lookback(self, tile, aggs, incs, compose, apply_, ident):
        if tile == 0:
            return None
        w, acc = self.warp, ident
        base = tile - 2 if self.skip and tile > 1 else tile - 1
        while True:
            js = [base - k for k in range(w)]
            inc = [j <= 0 or self.rng.random() < 0.3 for j in js]
            stop = inc.index(True) if any(inc) else w
            m = [aggs[j] if k < stop else ident for k, j in enumerate(js)]
            o = 1
            while o < w:
                m = [compose(m[k + o], m[k]) if k + o < w else m[k]
                     for k in range(w)]
                o *= 2
            acc = compose(m[0], acc)
            if stop < w:
                return apply_(acc, incs[base - stop])
            base -= w

    def scan(self, maps, compose, apply_, ident, init):
        """The state before every packet from per-packet ``maps``."""
        P, T = len(maps), self.tile
        tiles = -(-P // T)
        aggs, incs, pre = [], [], [None] * P
        for t in range(tiles):
            tm = maps[t * T:(t + 1) * T]
            tm = tm + [ident] * (T - len(tm))
            per = []
            for th in range(self.threads):
                m = ident
                for e in tm[th * self.items:(th + 1) * self.items]:
                    m = compose(m, e)
                per.append(m)
            ex, total = self.block_exclusive(per, compose, ident)
            got = self.lookback(t, aggs, incs, compose, apply_, ident)
            state_in = init if got is None else got
            aggs.append(total)
            incs.append(apply_(total, state_in))
            for th in range(self.threads):
                x = apply_(ex[th], state_in)
                for q in range(self.items):
                    i = t * T + th * self.items + q
                    if i < P:
                        pre[i] = x
                        x = apply_(tm[th * self.items + q], x)
        return pre

    def run(self, steps, psns, lasts, wins, tau=0.25, n_sample=32,
            alpha_max=64.0):
        """``(pre, post)``: ``[3, P]`` float32 rows step_min, psn_rec,
        alpha before and after each packet, as ``ref._state_walk``."""
        tau, n_sample, alpha_max = F32(tau), F32(n_sample), F32(alpha_max)
        P = len(steps)
        x = [F32(v) for v in steps]
        one = F32(1.0)
        a = [(1, F32(x[i] + one)) if lasts[i] else (0, x[i])
             for i in range(P)]
        smin = self.scan(a, _min_compose, _min_apply, MIN_ID, F32(0.0))
        smin_post = [_min_apply(a[i], smin[i]) for i in range(P)]
        op = [x[i] > smin[i] for i in range(P)]
        b = []
        for i in range(P):
            if wins[i] or lasts[i]:
                r = (1, F32(0.0))
            elif x[i] < smin[i]:
                r = (1, psns[i])
            else:
                r = (0, psns[i] if x[i] == smin[i] else -INF)
            c = (1, 0, 0) if wins[i] else (0, 1, int(op[i]))
            b.append(r + c)
        st = self.scan(b, _pc_compose, _pc_apply, PC_ID,
                       (F32(0.0), 0, 0))
        c = []
        for i in range(P):
            if not wins[i]:
                c.append(CLAMP_ID)
                continue
            cnt = F32(_sat(st[i][1] + 1))
            cnt_op = F32(_sat(st[i][2] + int(op[i])))
            have = cnt > n_sample
            d = (1 if cnt_op >= tau * cnt else -1) if have else 0
            c.append((d, one, alpha_max))
        alpha = self.scan(c, _clamp_compose, _clamp_apply, CLAMP_ID, one)
        pre = np.array([smin, [s[0] for s in st], alpha], np.float32)
        post = np.array([smin_post,
                         [_pc_apply(b[i], st[i])[0] for i in range(P)],
                         [_clamp_apply(c[i], alpha[i]) for i in range(P)]],
                        np.float32)
        return pre, post


def _model_outputs(model, arrays, exact, kw):
    steps, psns, lasts, wins, us = arrays
    opts = {k: kw[k] for k in ("tau", "n_sample", "alpha_max") if k in kw}
    pre, post = model.run(steps, [F32(v) for v in psns], lasts, wins,
                          **opts)
    out = SR.outputs_from_states(
        torch.from_numpy(steps), torch.from_numpy(psns),
        torch.from_numpy(us), torch.from_numpy(pre), torch.from_numpy(post),
        exact=exact, **{k: kw[k] for k in ("k", "n_warmup") if k in kw})
    return [x.numpy() for x in out]


SCAN_TRACES = SR.scan_traces(64)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "lut"])
@pytest.mark.parametrize("trace", list(SCAN_TRACES))
def test_scan_model_bitwise_vs_plain_and_reference(trace, exact):
    """The modelled scan equals the walk (``pipeline_plain``) and the
    reference kernel in interpret mode on all four outputs, bit for bit."""
    arrays, kw = SCAN_TRACES[trace]
    model = _model_outputs(ScanModel(seed=len(arrays[0])), arrays, exact,
                           kw)
    plain = _port(arrays, exact=exact, **kw)
    ref = _reference(arrays, exact=exact, **kw)
    for name, m, p, r in zip(("marks", "step_min", "psn_rec", "alpha"),
                             model, plain, ref):
        assert m.dtype == p.dtype == r.dtype, name
        assert np.array_equal(m.view(np.int32), p.view(np.int32)), name
        assert np.array_equal(p.view(np.int32), r.view(np.int32)), name


def test_scan_traces_put_their_cases_on_tile_edges():
    """What ``scan_traces`` promises, at the model's tile and at the
    kernel's."""
    for tile in (64, SK.TILE):
        tr = SR.scan_traces(tile)
        steps, _, lasts, wins, _ = tr["edges"][0]
        assert len(steps) % tile and len(steps) > 4 * tile
        for e in (tile - 1, tile, 2 * tile - 1, 3 * tile):
            assert lasts[e]
        for e in (tile - 1, 2 * tile, 3 * tile - 1, 4 * tile):
            assert wins[e]
        steps, _, lasts, wins, _ = tr["spans"][0]
        for t in (1, 2):                     # tiles with neither event
            assert not (lasts[t * tile:(t + 1) * tile].any() or
                        wins[t * tile:(t + 1) * tile].any())
        pre, _ = SR._state_walk(steps, tr["spans"][0][1], lasts, wins,
                                0.25, 32, 64.0)
        at_min = steps == pre[0]
        assert at_min[tile:3 * tile].mean() > 0.5   # an equal-step run
        _, post = SR._state_walk(*tr["clamps"][0][:4], 0.25, 32, 5.5)
        assert post[2].max() == F32(5.5) and post[2][-1] == 1.0
        assert all(len(tr[n][0][0]) == 1 for n in ("p1_plain", "p1_last",
                                                   "p1_win"))


@pytest.mark.parametrize("fault", ["skip", "saturate"])
def test_scan_model_planted_faults_fail(fault):
    """The model's planted faults, the ones chip_smoke.py plants in the
    kernel: a look-back that skips its nearest predecessor, and counts
    that do not saturate.  The first parts from the walk on the edge
    traces; the second on counts past 2^24, in closed form (the traces
    cannot reach them): the walk's window end after 2^24 + 2^20 packets
    sees cnt = cnt_op = 2^24 (float32 +1.0 stops there)."""
    if fault == "skip":
        arrays, kw = SCAN_TRACES["edges"]
        model = _model_outputs(ScanModel(skip=True), arrays, True, kw)
        plain = _port(arrays, exact=True, **kw)
        assert any(not np.array_equal(m, p) for m, p in zip(model, plain))
        return
    n = SAT + (1 << 20)
    for saturate, want in ((True, 2.0), (False, 1.0)):
        _sat_ = _sat if saturate else int
        cnt = F32(_sat_(n))
        cnt_op = F32(_sat_(n - (1 << 20)))
        d = (1 if cnt_op >= F32(1.0) * cnt else -1) if cnt > 32 else 0
        assert _clamp_apply(_clamp_compose(CLAMP_ID, (d, F32(1), F32(64))),
                            F32(1.0)) == F32(want)


def test_count_maps_saturate_like_repeated_float32_adds():
    """Composed count maps whose sums cross 2^24 give float(min(n, 2^24)),
    which is what float32 ``+1.0`` repeated n times from 0 gives (numpy's
    accumulate adds in order)."""
    ones = np.ones(SAT + 64, np.float32)
    walk = np.add.accumulate(ones, dtype=np.float32)
    assert walk[SAT - 1] == F32(SAT) and walk[-1] == F32(SAT)
    cases = [(SAT - 5, 3), (SAT - 5, 10), (SAT - 1, 1), (SAT // 2,
             SAT // 2 + 7), (1000, SAT - 1000 + 63), (SAT, 1)]
    for a, b in cases:
        add_a, add_b = (0, -INF, 0, a, a), (0, -INF, 0, b, b)
        state = _pc_apply(_pc_compose(add_a, add_b), (F32(0), 0, 0))
        n = a + b
        assert F32(state[1]) == walk[n - 1] == F32(min(n, SAT)), (a, b)
        # the same sum in other brackets, as tiles compose them
        for cut in (1, a // 2, a):
            left = (0, -INF, 0, cut, cut)
            right = _pc_compose((0, -INF, 0, a - cut, a - cut), add_b)
            state = _pc_apply(_pc_compose(left, right), (F32(0), 0, 0))
            assert F32(state[1]) == walk[n - 1], (a, b, cut)
    # a reset inside the composition starts the count again
    reset = (1, F32(0), 1, 0, 0)
    state = _pc_apply(_pc_compose(_pc_compose((0, -INF, 0, SAT, SAT), reset),
                                  (0, -INF, 0, 5, 2)), (F32(0), 0, 0))
    assert state[1:] == (5, 2)
