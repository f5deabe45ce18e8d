#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Drives the port's main paths — the fluid network simulator with the fused
netsim tick (``backend="cuda"``, ``tick_window=1``), with the multi-tick
window kernel (``tick_window > 1``), with the tiled tick
(``segsum="onehot"``, ``blk``) on the 512-host grid, the online controller,
and the Alg. 1 switch pipeline — phase by phase, one line per phase, and
exits non-zero at the first phase that fails:

1. build    compile every kernel library from the checkout (one nvcc per
            source, in parallel, sm_90a); print the card's name and power
            limit from nvidia-smi
2. math     the window kernel's expf/log1pf against torch's CUDA exp/log1p
            over the ranges the tick feeds them (ulps reported)
3. kernel   the single-tick kernel against its plain torch version on the
            card, on mid-run states (300 eager ticks first) at the Table-1
            shape and the 128-host fat_tree_multipod shape (8 lanes),
            sym_on/pq_on on and off (as lanes) and per_step_ecmp on and off
4. window   the window kernel against its plain version (eager ticks) on
            the card from the same mid-run states: windows of 20 and 7
5. tiled    the tiled kernel against its plain version on mid-run states:
            Table 1 (blk=256, 4 lanes; also blk=300, a ragged last block,
            and 2048, one block), 128 hosts (blk=1024) and 512 hosts
            (blk=2048), 8 lanes each
6. large    the tick and window kernels at 256 and 512 hosts (8 lanes),
            whose link ids live in global memory, against their plain
            versions: 10 ticks, windows of 20 and 7
7. switch   the switch-pipeline kernel against its plain version at 8,000
            packets on both marking paths; then the entry point on a
            1,000,000-packet trace (its main path, launches counted)
8. goldens  Table 1, 20,000 ticks, seed 3: the ecmp_base and ecmp_sym golden
            finish ticks (two lanes of one grid run) through
            backend="cuda" with tick_window 1 (one tick launch per tick),
            20 (1,000 window launches) and 7 (3,000), and through the tiled
            tick with blk=256 (20,000 tiled launches)
9. multipod 128-host fat_tree_multipod, 8 seeds as lanes, 2,000 ticks:
            backend="cuda" with tick_window 1 and 20 (the main-path runs
            whose launches are counted) against backend="eager"
10. grid512 the 512-host grid (16 pods; sym off/on x 4 seeds as lanes),
            1,000 ticks: the tiled tick (blk=2048, tick_window=1) and the
            window kernel (tick_window=20), their launches counted, against
            their plain versions on the card and against eager
11. control SimController on the card (Table 1, window_ticks=640,
            tick_window=20): stepping equals one-shot simulate, tau retuned
            mid-run, checkpoint/restore replays bit for bit
12. timing  each kernel's device time per launch against its plain
            version's and its bound, at the main paths' shapes
13. profile main-path ticks/s (Table 1 with 1 lane through ``simulate``,
            128 hosts x 8 lanes, 512 hosts x 8 lanes) and where a tick's
            time goes: wall and device-busy time, the busiest kernels

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py build tiled  # a subset (no report lines)

It needs one CUDA card and the CUDA toolkit; without a card it exits
non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_OPS_PER_S = 67e12           # H100 SXM float32 rate outside tensor cores
SM_HZ = 1.98e9                  # H100 SXM boost clock: sizes spin kernels

# Table-1 golden constants (seed 3, 20,000 ticks, window 64), the same
# values the reference's engine tests hold.
GOLDEN_JOB = {"ecmp_base": 10757, "ecmp_sym": 7900}
GOLDEN_FLOWS = {
    "ecmp_base": [
        9296, 7344, 7659, 8375, 8795, 9180, 9359, 9439, 10450, 10648, 10728,
        10601, 10268, 10348, 9887, 10228, 10658, 10757, 10754, 10205, 10011,
        10053, 10007, 10383, 9050, 9050, 9009, 8801, 8734, 9119, 9081, 9107],
    "ecmp_sym": [
        7853, 7891, 7769, 7877, 7837, 7864, 7698, 7900, 7845, 7894, 7802,
        7889, 7807, 7843, 7699, 7893, 7824, 7892, 7825, 7878, 7748, 7860,
        7698, 7861, 7853, 7877, 7764, 7877, 7747, 7835, 7692, 7891],
}
# Kernels and plain versions add every float sum in the same order and
# without fused multiply-adds, so they should agree to the bit; the
# tolerance admits a few ulps (float32 ulp ~ 6e-8 relative) and no more.
RTOL = 1e-6
# The window kernel's per-job throughput sample is a block reduction, in
# another order than torch's sum(dim=2).
RTOL_TPUT = 1e-5
INT_SERIES = ("finish_ticks", "job_finish_ticks", "ts_min_wire",
              "ts_max_wire", "ts_done_min", "ts_alpha_max")
PHASES = ("build", "math", "kernel", "window", "tiled", "large", "switch",
          "goldens", "multipod", "grid512", "control", "timing", "profile")
# instance tile of the tiled tick at each shape (a multiple of the window)
BLK = {"table1": 256, "multipod128": 1024, "multipod512": 2048}
# the shape of each kernel's main path, whose timing goes in the report
MAIN_SHAPE = {"netsim_tick": "multipod128", "netsim_window": "multipod128",
              "netsim_tiled": "multipod512",
              "switch_pipeline": "P=1000000"}
WARM = 300                      # eager ticks before the kernel checks


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> None:
    raise SystemExit(f"[{phase}] FAILED: {msg}")


def table1(T):
    topo = T.make_leaf_spine(32, 4, 4)
    b = T.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(32)), ring_size=8, chunk_bytes=1e6,
                   passes=2, barrier=False)
    return topo, b.build(), T.SimParams(n_ticks=20_000, window=64)


def multipod(T, n_pods: int, n_ticks: int):
    """benchmarks/grid512.py's full configuration at ``32 * n_pods`` hosts:
    pods of 4 ToRs x 8 hosts with 4 spines, 8 cores at 1:2
    oversubscription, rings of 32, 8 MB chunks, coarse 20 us ticks; cut to
    ``n_ticks`` ticks."""
    topo = T.make_fat_tree(n_pods, 4, 4, 8, 8, core_oversubscription=2.0)
    b = T.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(32 * n_pods)), ring_size=32,
                   chunk_bytes=8e6, passes=1, barrier=False)
    cfg = T.SimParams(n_ticks=n_ticks, window=64, dt=20e-6, sym_win_ticks=5,
                      cc_epoch_ticks=2)
    return topo, b.build(), cfg


def multipod128(T):
    """The 128-host grid (4 pods, 4 spines a pod, 8 cores at 1:2), cut to
    2,000 ticks."""
    return multipod(T, 4, 2000)


SHAPES = {"table1": table1, "multipod128": multipod128,
          "multipod256": lambda T: multipod(T, 8, 1000),
          "multipod512": lambda T: multipod(T, 16, 1000)}


def lane_knobs(T, cfg):
    """The four knob points (sym_on, pq_on) in {0,1}^2."""
    return T.stack_knobs([
        cfg._replace(sym_on=bool(i % 2), pq_on=bool(i // 2)).knobs()
        for i in range(4)])


def tensor_bytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def timed(fn, n: int, torch) -> tuple[float, float]:
    """``(device ms, wall ms)`` per call of ``fn`` over ``n`` calls, after
    a warm-up, from CUDA events.  Wall: the calls made one after another,
    host time between them included.  Device: the same calls queued behind
    a spin kernel that outlasts queueing them, so that the card runs them
    back to back and the events span only their device work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = a.elapsed_time(b) / n
    torch.cuda._sleep(int((2 * enqueue_s + 0.005) * SM_HZ))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, wall


def profile_ticks(run, torch) -> tuple[float, dict]:
    """Profile ``run()``: returns ``(wall us, {kernel name: (count,
    device us)})``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    return wall_us, by_name


class Smoke:
    """The phases, sharing the port's modules, the card and what earlier
    phases measured."""

    def __init__(self, torch):
        self.torch = torch
        sys.path.insert(0, str(ROOT / "src"))
        import repro_torch.core.netsim as T
        from repro_torch.kernels.netsim_tick import kernel as K
        from repro_torch.kernels.netsim_tick import ref as Rf
        from repro_torch.kernels.netsim_tick import tiled as Tl
        from repro_torch.kernels.netsim_tick import window as Wn
        from repro_torch.kernels import switch_pipeline as Sp
        self.T, self.K, self.Rf, self.Wn, self.Tl, self.Sp = \
            T, K, Rf, Wn, Tl, Sp
        self.dev = torch.device("cuda")
        self.card = "nvidia-smi unavailable"
        self.mid = {}           # (shape, ecmp) -> (ctx, cfg, state, tick)
        self.max_err = {"netsim_tick": 0.0, "netsim_window": 0.0,
                        "netsim_tiled": 0.0, "switch_pipeline": 0.0}
        self.launches = {}
        self.rates = {}
        self.reports = []
        self.eager128 = None

    # ---------------------------------------------------------- 1. build
    def build(self):
        from repro_torch.kernels import _build
        torch = self.torch
        t0 = time.time()
        libs = _build.build_all()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        if smi.stdout.strip():
            self.card = smi.stdout.strip().splitlines()[0]
        for name, (_, log) in libs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    say("build", f"{name}: {line.strip()}")
        say("build", f"{', '.join(libs)} built in {time.time() - t0:.1f} s "
                     "(in parallel)")
        print(self.card, flush=True)
        from repro_torch.core.netsim.stages import ordered_segment_sum
        g = torch.Generator().manual_seed(0)
        idx = torch.randint(0, 97, (2, 8192), generator=g)
        vals = torch.rand(2, 8192, generator=g) * 1e9
        base = torch.rand(2, 97, generator=g)
        dev = self.dev
        if not torch.equal(ordered_segment_sum(base, idx, vals),
                           ordered_segment_sum(base.to(dev), idx.to(dev),
                                               vals.to(dev)).cpu()):
            fail("build", "ordered_segment_sum on the card differs from the "
                          "CPU order")
        say("build", "ordered_segment_sum on the card equals the CPU order")

    # ----------------------------------------------------------- 2. math
    def math(self):
        """The window kernel calls expf on -lam (lam >= 0, the expected
        marks of a DCQCN epoch) and on the summed log no-mark terms
        (>= H * log1p(-0.999999) ~ -83), and log1pf on -p_hop with p_hop in
        [0, 0.999999]; the eager tick calls torch's exp/log1p there."""
        torch, dev = self.torch, self.dev
        n = 1 << 22
        cases = {
            "exp": torch.linspace(-100.0, 0.0, n, device=dev),
            "log1p": -torch.linspace(0.0, 0.999999, n, device=dev),
        }
        for name, x in cases.items():
            e, lp = self.Wn.kernel_math(x.contiguous())
            mine = e if name == "exp" else lp
            ref = torch.exp(x) if name == "exp" else torch.log1p(x)
            ulp = (mine.view(torch.int32).long() -
                   ref.view(torch.int32).long()).abs()
            if not torch.isfinite(mine).all():
                fail("math", f"kernel {name} gave non-finite values")
            say("math", f"{name}: kernel vs torch on {n} points in the tick's "
                        f"range: {int((ulp != 0).sum())} differ, max "
                        f"{int(ulp.max())} ulp")
            if int(ulp.max()) > 2:
                fail("math", f"kernel {name} is {int(ulp.max())} ulp off")

    def mid_state(self, shape: str, ecmp: bool):
        """A mid-run engine state (``WARM`` eager ticks) of the 4-knob-point
        lanes: Table 1 x 1 seed, or a multipod grid x 2 seeds."""
        key = (shape, ecmp)
        if key not in self.mid:
            T, torch = self.T, self.torch
            from repro_torch.core.netsim.stages import engine_tick_eager
            topo, wl, cfg = SHAPES[shape](T)
            seeds = [0] if shape == "table1" else [0, 1]
            ctx, ecfg, sim = T.make_lanes(
                topo, wl, cfg._replace(backend="cuda").structure(),
                lane_knobs(T, cfg), seeds=seeds,
                routing="ecmp" if ecmp else "ecmp_flow", device=self.dev)
            state = sim.engine
            with torch.no_grad():
                for tick in range(WARM):
                    state, _ = engine_tick_eager(ctx, ecfg, state, tick,
                                                 False)
            self.mid[key] = (ctx, ecfg, state, WARM)
        return self.mid[key]

    def compare(self, phase, what, x, y, rtol=RTOL, kernel=None) -> float:
        """Fail unless ``x`` equals ``y`` (integers) or is allclose at
        ``rtol``; returns the max abs error."""
        torch = self.torch
        if x.dtype in (torch.int32, torch.int64):
            if not torch.equal(x, y):
                fail(phase, f"{what} differs")
            return 0.0
        err = (x - y).abs().max().item() if x.numel() else 0.0
        if kernel:
            self.max_err[kernel] = max(self.max_err[kernel], err)
        if not torch.isfinite(x).all() or \
                not torch.allclose(x, y, rtol=rtol, atol=0.0):
            fail(phase, f"{what}: max abs err {err}")
        return err

    # -------------------------------------------- 3. tick kernel vs plain
    def kernel(self):
        torch, K, Rf = self.torch, self.K, self.Rf
        from repro_torch.core.netsim.stages import (engine_tick_eager,
                                                    stage_starts)
        from repro_torch.kernels.netsim_tick.ops import tick_operands
        for shape in ("table1", "multipod128"):
            for ecmp in (True, False):
                ctx, ecfg, state, t0 = self.mid_state(shape, ecmp)
                with torch.no_grad():
                    for tick in range(t0, t0 + 10):
                        starts = stage_starts(ctx, state, tick)
                        args, kw = tick_operands(ctx, ecfg, starts, state,
                                                 tick)
                        out = K.netsim_tick(*args, **kw)
                        ref = Rf.hot_tick(*args, **kw)
                        torch.cuda.synchronize()
                        for f in out._fields:
                            self.compare("kernel", f"{shape} ecmp={ecmp} "
                                         f"tick {tick}: {f}", getattr(out, f),
                                         getattr(ref, f),
                                         kernel="netsim_tick")
                        state, _ = engine_tick_eager(ctx, ecfg, state, tick,
                                                     False)
                active = int((starts.step_of >= 0).sum())
                say("kernel", f"{shape} lanes={ctx.B} per_step_ecmp={ecmp}: "
                              f"ticks {t0}-{t0 + 9} equal (ints exact, "
                              f"floats rtol {RTOL}); {active} occupied "
                              "instances")
        say("kernel", "max abs float error kernel vs plain: "
                      f"{self.max_err['netsim_tick']}")

    # ------------------------------------------ 4. window kernel vs plain
    def window(self):
        torch, Rf, Wn = self.torch, self.Rf, self.Wn
        state_err = 0.0
        for shape in ("table1", "multipod128"):
            for ecmp in (True, False):
                ctx, ecfg, state, base = self.mid_state(shape, ecmp)
                for n in (20, 7):
                    kst, ksm = Wn.netsim_window(ctx, ecfg, state, base, n)
                    rst, rsm = Rf.window_ref(ctx, ecfg, state, base, n)
                    torch.cuda.synchronize()
                    what = f"{shape} ecmp={ecmp} ticks {base}-{base + n - 1}"
                    for f in kst._fields:
                        state_err = max(state_err, self.compare(
                            "window", f"{what}: state {f}", getattr(kst, f),
                            getattr(rst, f), kernel="netsim_window"))
                    names = ("min_wire", "max_wire", "done_min", "throughput",
                             "qmax", "alpha_max")
                    for f, x, y in zip(names, ksm, rsm):
                        self.compare("window", f"{what}: sample {f}", x, y,
                                     rtol=RTOL_TPUT if f == "throughput"
                                     else RTOL, kernel="netsim_window")
                    state, base = rst, base + n
                say("window", f"{shape} lanes={ctx.B} per_step_ecmp={ecmp}: "
                              "windows of 20 and 7 ticks equal the plain "
                              f"version (ints and alpha exact, floats rtol "
                              f"{RTOL}, throughput rtol {RTOL_TPUT})")
        say("window", "max abs float error kernel vs plain: "
                      f"{self.max_err['netsim_window']} (state alone: "
                      f"{state_err}; the rest is the throughput sample)")

    # ------------------------------------------- 5. tiled kernel vs plain
    def tiled(self):
        torch, Tl, Rf = self.torch, self.Tl, self.Rf
        from repro_torch.core.netsim.stages import (engine_tick_eager,
                                                    stage_starts)
        from repro_torch.kernels.netsim_tick.ops import tiled_operands
        # each shape's main-path tile; at Table 1 also a tile that does not
        # divide FW (a ragged last block) and one block of the whole axis
        # (the untiled onehot tick)
        runs = [(shape, BLK[shape], ecmp)
                for shape in ("table1", "multipod128", "multipod512")
                for ecmp in (True, False)]
        runs += [("table1", 300, True), ("table1", 2048, True)]
        for shape, blk, ecmp in runs:
            ctx, ecfg, state, t0 = self.mid_state(shape, ecmp)
            n = 10 if shape != "multipod512" else 5
            with torch.no_grad():
                for tick in range(t0, t0 + n):
                    starts = stage_starts(ctx, state, tick)
                    args, kw = tiled_operands(ctx, ecfg, starts, state,
                                              tick, blk)
                    out = Tl.netsim_tiled(*args, **kw)
                    ref = Rf.tiled_tick_ref(*args, **kw)
                    torch.cuda.synchronize()
                    for f in out._fields:
                        self.compare("tiled", f"{shape} blk={blk} "
                                     f"ecmp={ecmp} tick {tick}: {f}",
                                     getattr(out, f), getattr(ref, f),
                                     kernel="netsim_tiled")
                    state, _ = engine_tick_eager(ctx, ecfg, state, tick,
                                                 False)
            nb = -(-ctx.FW // blk)
            say("tiled", f"{shape} lanes={ctx.B} blk={blk} ({nb} blocks"
                         f" of {ctx.FW} instances) per_step_ecmp={ecmp}:"
                         f" ticks {t0}-{t0 + n - 1} equal the plain "
                         f"version (ints exact, floats rtol {RTOL})")
        say("tiled", "max abs float error kernel vs plain: "
                     f"{self.max_err['netsim_tiled']}")

    # ------------------------- 6. tick and window kernels at 256-512 hosts
    def large(self):
        torch, K, Rf, Wn = self.torch, self.K, self.Rf, self.Wn
        from repro_torch.core.netsim.stages import (engine_tick_eager,
                                                    stage_starts)
        from repro_torch.kernels.netsim_tick.ops import tick_operands
        for shape in ("multipod256", "multipod512"):
            ctx, ecfg, state, t0 = self.mid_state(shape, True)
            split = Wn.window_smem_split(ctx.F, ctx.FW, ctx.H, ctx.L + 1,
                                         ctx.J, ctx.DJ)
            if not split.ids:
                fail("large", f"{shape}: expected the link ids in global "
                              "memory")
            tick_state = state
            with torch.no_grad():
                for tick in range(t0, t0 + 3):
                    starts = stage_starts(ctx, tick_state, tick)
                    args, kw = tick_operands(ctx, ecfg, starts, tick_state,
                                             tick)
                    out = K.netsim_tick(*args, **kw)
                    ref = Rf.hot_tick(*args, **kw)
                    torch.cuda.synchronize()
                    for f in out._fields:
                        self.compare("large", f"{shape} tick {tick}: {f}",
                                     getattr(out, f), getattr(ref, f),
                                     kernel="netsim_tick")
                    tick_state, _ = engine_tick_eager(ctx, ecfg, tick_state,
                                                      tick, False)
            base = t0
            for n in (20, 7):
                kst, ksm = Wn.netsim_window(ctx, ecfg, state, base, n)
                rst, rsm = Rf.window_ref(ctx, ecfg, state, base, n)
                torch.cuda.synchronize()
                what = f"{shape} ticks {base}-{base + n - 1}"
                for f in kst._fields:
                    self.compare("large", f"{what}: state {f}",
                                 getattr(kst, f), getattr(rst, f),
                                 kernel="netsim_window")
                for i, (x, y) in enumerate(zip(ksm, rsm)):
                    self.compare("large", f"{what}: sample {i}", x, y,
                                 rtol=RTOL_TPUT if i == 3 else RTOL,
                                 kernel="netsim_window")
                state, base = rst, base + n
            say("large", f"{shape} lanes={ctx.B} (FW={ctx.FW}, L+1="
                         f"{ctx.L + 1}): link ids in {split.ids} bytes of "
                         f"global memory a lane, {split.smem} bytes of shared"
                         f" memory; tick kernel ticks {t0}-{t0 + 2} and "
                         f"windows of 20 and 7 equal the plain versions")

    # -------------------------------------------------- 7. switch pipeline
    def switch_trace(self, n: int, seed: int):
        """A packet trace like tests/test_kernels.py's, on the card."""
        import numpy as np
        rng = np.random.default_rng(seed)
        steps = np.maximum(0, rng.integers(0, 4, n) + np.arange(n) // 200)
        arrays = (steps.astype(np.int32),
                  rng.integers(1, 5000, n).astype(np.float32),
                  (rng.random(n) < 0.02).astype(np.int32),
                  (np.arange(n) % 100 == 99).astype(np.int32),
                  rng.random(n).astype(np.float32))
        return [self.torch.from_numpy(a).to(self.dev) for a in arrays]

    def switch(self):
        torch, Sp = self.torch, self.Sp
        small = self.switch_trace(8000, 7)
        for exact in (True, False):
            saved = Sp.switch_pipeline.launches
            out = Sp.switch_pipeline(*small, exact=exact)
            Sp.switch_pipeline.launches = saved
            ref = Sp.pipeline_plain(*small, exact=exact)
            torch.cuda.synchronize()
            for name, x, y in zip(("marks", "step_min", "psn_rec", "alpha"),
                                  out, ref):
                self.compare("switch", f"P=8000 exact={exact}: {name}", x, y,
                             kernel="switch_pipeline")
            say("switch", f"P=8000 exact={exact}: kernel equals the plain "
                          f"version; {int(out[0].sum())} marks")
        # the main path: the entry point on a 1,000,000-packet trace
        big = self.switch_trace(1_000_000, 11)
        Sp.switch_pipeline.launches = 0
        t0 = time.time()
        ex = Sp.switch_pipeline(*big, exact=True)
        lut = Sp.switch_pipeline(*big, exact=False)
        torch.cuda.synchronize()
        secs = time.time() - t0
        self.launches["switch_pipeline"] = Sp.switch_pipeline.launches
        if Sp.switch_pipeline.launches != 2:
            fail("switch", f"{Sp.switch_pipeline.launches} launches for two "
                           "calls")
        for x, y in zip(ex[1:], lut[1:]):
            if not torch.equal(x, y):
                fail("switch", "the state trajectory depends on the marking "
                               "path")
        if not all(torch.isfinite(x).all() for x in ex[2:]):
            fail("switch", "non-finite state")
        re, rl = ex[0].float().mean().item(), lut[0].float().mean().item()
        if not abs(re - rl) < 0.02 + 0.25 * re:
            fail("switch", f"LUT mark rate {rl} vs exact {re}")
        # the state is causal: the trace's first 50,000 packets alone give
        # the same outputs, which the plain version checks
        head = [x[:50_000].contiguous() for x in big]
        ref = Sp.pipeline_plain(*head, exact=True)
        for name, x, y in zip(("marks", "step_min", "psn_rec", "alpha"),
                              ex, ref):
            self.compare("switch", f"P=1e6 first 50,000: {name}",
                         x[:50_000], y, kernel="switch_pipeline")
        say("switch", f"P=1,000,000: both paths in {secs:.2f} s (2 "
                      f"launches), mark rate exact {re:.4f}, LUT {rl:.4f}, "
                      "same state trajectory; first 50,000 packets equal the"
                      " plain version")

    # ------------------------------------------------------- 8. goldens
    def goldens(self):
        torch, T, K, Wn = self.torch, self.T, self.K, self.Wn
        topo, wl, cfg = table1(T)
        knobs = T.stack_knobs([cfg.knobs(),
                               cfg._replace(sym_on=True).knobs()])
        R = cfg.record_every
        # tick_window=1: a tick launch per tick; w > 1: each record period
        # runs R // w windows of w ticks and one of R % w
        # (tick_window, blk, tick, window and tiled launches expected)
        for tw, blk, want in (
                (1, None, (cfg.n_ticks, 0, 0)),
                (20, None, (0, cfg.n_ticks // R, 0)),
                (7, None, (0, cfg.n_ticks // R * -(-R // 7), 0)),
                (1, BLK["table1"], (0, 0, cfg.n_ticks))):
            K.netsim_tick.launches = 0
            Wn.netsim_window.launches = 0
            self.Tl.netsim_tiled.launches = 0
            t0 = time.time()
            res = T.simulate_grid(
                topo, wl, cfg._replace(
                    backend="cuda", tick_window=tw, blk=blk,
                    segsum="onehot" if blk else "scatter").structure(),
                knobs, seeds=[3], routing="ecmp", device=self.dev)
            torch.cuda.synchronize()
            secs = time.time() - t0
            nt, nw = K.netsim_tick.launches, Wn.netsim_window.launches
            ntl = self.Tl.netsim_tiled.launches
            if (nt, nw, ntl) != want:
                fail("goldens", f"tick_window={tw} blk={blk}: {nt} tick, "
                                f"{nw} window and {ntl} tiled launches for "
                                f"{cfg.n_ticks} ticks")
            for k, name in enumerate(("ecmp_base", "ecmp_sym")):
                job = int(res.job_finish_ticks[k, 0, 0])
                flows = res.finish_ticks[k, 0].cpu().tolist()
                if job != GOLDEN_JOB[name] or flows != GOLDEN_FLOWS[name]:
                    fail("goldens", f"tick_window={tw} blk={blk} {name}: "
                                    f"job finish {job}, flows {flows}")
            say("goldens", f"tick_window={tw} blk={blk}: ecmp_base "
                           f"{GOLDEN_JOB['ecmp_base']} and ecmp_sym "
                           f"{GOLDEN_JOB['ecmp_sym']} with all {len(flows)} "
                           f"flow finish ticks; 2 lanes x {cfg.n_ticks} "
                           f"ticks, {nt} tick + {nw} window + {ntl} tiled "
                           f"launches, {cfg.n_ticks / secs:.1f} ticks/s")

    # ---------------------------------------------- 9. 128-host, 8 lanes
    def multipod(self):
        torch, T, K, Wn = self.torch, self.T, self.K, self.Wn
        topo, wl, cfg = multipod128(T)
        seeds = list(range(8))
        cfg = cfg._replace(sym_on=True)
        eager = T.simulate_seeds(topo, wl, cfg, "ecmp", seeds,
                                 device=self.dev)
        torch.cuda.synchronize()
        for tw, kname, want in ((1, "netsim_tick", cfg.n_ticks),
                                (20, "netsim_window", cfg.n_ticks // 20)):
            counter = K.netsim_tick if tw == 1 else Wn.netsim_window
            counter.launches = 0                     # main path starts
            t0 = time.time()
            fused = T.simulate_seeds(
                topo, wl, cfg._replace(backend="cuda", tick_window=tw),
                "ecmp", seeds, device=self.dev)
            torch.cuda.synchronize()
            secs = time.time() - t0
            n = counter.launches                     # main path ends
            if n != want or n == 0:
                fail("multipod", f"tick_window={tw}: {n} {kname} launches "
                                 f"for {cfg.n_ticks} ticks")
            self.launches[kname] = n
            for f in INT_SERIES:
                if not torch.equal(getattr(eager, f), getattr(fused, f)):
                    fail("multipod", f"tick_window={tw}: cuda and eager "
                                     f"differ in {f}")
            err = (eager.ts_throughput -
                   fused.ts_throughput).abs().max().item()
            if not torch.isfinite(fused.ts_throughput).all() or \
                    not torch.allclose(eager.ts_throughput,
                                       fused.ts_throughput, rtol=RTOL_TPUT):
                fail("multipod", f"tick_window={tw}: throughput series "
                                 f"differ: {err}")
            rate = cfg.n_ticks / secs
            self.rates[("multipod128", tw)] = rate
            done = fused.ts_done_min[:, -1, 0].tolist()
            say("multipod", f"tick_window={tw}: 8 lanes x {cfg.n_ticks} "
                            "ticks, cuda == eager on every integer series "
                            f"(throughput max abs diff {err}); steps done "
                            f"per lane {done}; {n} {kname} launches; "
                            f"{rate:.1f} ticks/s ({rate * 8:.1f} "
                            "lane-ticks/s)")

    # --------------------------------------- 10. 512 hosts, 8 lanes, tiled
    def grid512(self):
        torch, T, Tl, Wn, Rf = self.torch, self.T, self.Tl, self.Wn, self.Rf
        from repro_torch.kernels.netsim_tick import ops
        topo, wl, cfg = multipod(T, 16, 1000)
        knobs = T.stack_knobs([cfg.knobs(), cfg._replace(sym_on=True).knobs()])
        seeds = [0, 1, 2, 3]

        def run(**kw):
            torch.cuda.synchronize()
            t0 = time.time()
            res = T.simulate_grid(topo, wl, cfg._replace(**kw).structure(),
                                  knobs, seeds=seeds, routing="ecmp",
                                  device=self.dev)
            torch.cuda.synchronize()
            return res, cfg.n_ticks / (time.time() - t0)

        eager, eager_rate = run()
        tiled_kw = dict(backend="cuda", segsum="onehot", blk=BLK["multipod512"])
        Tl.netsim_tiled.launches = 0                 # main path starts
        tiled, rate1 = run(**tiled_kw)
        n_tiled = Tl.netsim_tiled.launches           # main path ends
        Wn.netsim_window.launches = 0                # main path starts
        win, rate20 = run(backend="cuda", tick_window=20)
        n_win = Wn.netsim_window.launches            # main path ends
        if n_tiled != cfg.n_ticks or n_win != cfg.n_ticks // 20:
            fail("grid512", f"{n_tiled} tiled and {n_win} window launches "
                            f"for {cfg.n_ticks} ticks")
        self.launches["netsim_tiled"] = n_tiled
        self.rates[("multipod512", 1)] = rate1
        self.rates[("multipod512", 20)] = rate20
        # the tiled tick's plain version on the card, through the same path
        saved = ops.netsim_tiled
        ops.netsim_tiled = Rf.tiled_tick_ref
        try:
            plain, _ = run(**tiled_kw)
        finally:
            ops.netsim_tiled = saved
        R = cfg.record_every
        for name, x, ref in (("tiled vs its plain version", tiled, plain),
                             ("tick_window=20 vs eager", win, eager)):
            for f in T.SimResult._fields:
                a, b = getattr(x, f), getattr(ref, f)
                if f in INT_SERIES:
                    if not torch.equal(a, b):
                        fail("grid512", f"{name}: {f} differs")
                else:
                    self.compare("grid512", f"{name}: {f}", a, b,
                                 rtol=RTOL_TPUT if f == "ts_throughput"
                                 else RTOL)
        # the tiled tick against eager: onehot's contract is allclose on
        # floats, so integer series may part; count where and report
        diffs, first = 0, None
        for f in INT_SERIES:
            d = getattr(tiled, f) != getattr(eager, f)
            diffs += int(d.sum())
            if f.startswith("ts_") and d.any():
                # [K, S, T, ...] -> the first record period that differs
                t = int(torch.nonzero(d.transpose(0, 2).reshape(
                    d.shape[2], -1).any(1))[0])
                tick = (t + 1) * R - 1
                first = tick if first is None else min(first, tick)
        err = (tiled.ts_throughput - eager.ts_throughput).abs().max().item()
        done = win.ts_done_min[:, :, -1, 0].flatten().tolist()
        wire = win.ts_max_wire[:, :, -1, 0].flatten().tolist()
        say("grid512", f"8 lanes x {cfg.n_ticks} ticks at 512 hosts: tiled "
                       f"(blk={BLK['multipod512']}) == its plain version on "
                       f"every integer series ({n_tiled} tiled launches, "
                       f"{rate1:.1f} ticks/s); tick_window=20 == eager "
                       f"({n_win} window launches, {rate20:.1f} ticks/s); "
                       f"eager {eager_rate:.1f} ticks/s; steps done per lane"
                       f" {done}, newest wire step {wire}")
        say("grid512", f"tiled vs eager: {diffs} integer entries differ"
                       + (f", first at tick {first}" if first is not None
                          else "") + f"; throughput max abs diff {err}")

    # ------------------------------------------------------- 11. control
    def control(self):
        torch, T, Wn = self.torch, self.T, self.Wn
        topo, wl, cfg = table1(T)
        cfg = cfg._replace(n_ticks=3200, sym_on=True, backend="cuda",
                           tick_window=20)
        one = T.simulate(topo, wl, cfg, routing="ecmp", seed=3,
                         device=self.dev)
        ctl = T.SimController(topo, wl, cfg, window_ticks=640, seed=3)
        Wn.netsim_window.launches = 0
        parts = []
        for _ in range(cfg.n_ticks // 640):
            state, obs = ctl.step()
            parts.append(obs.samples)
        if Wn.netsim_window.launches != cfg.n_ticks // 20:
            fail("control", f"{Wn.netsim_window.launches} window launches "
                            f"for {cfg.n_ticks} ticks")
        if obs.tick != cfg.n_ticks or \
                not torch.equal(state.engine.finish[0], one.finish_ticks) or \
                not torch.equal(state.engine.job_finish[0],
                                one.job_finish_ticks):
            fail("control", "stepped run differs from one-shot simulate")
        for f in T.WindowSamples._fields:
            if not torch.equal(torch.cat([getattr(p, f) for p in parts]),
                               getattr(one, f)):
                fail("control", f"stepped series {f} differs from one-shot")
        say("control", f"5 steps of 640 ticks equal one-shot simulate bit "
                       f"for bit (every series); {Wn.netsim_window.launches}"
                       " window launches")
        ctl.reset()
        ctl.step()
        snap = ctl.checkpoint()
        if snap.engine.sent.device.type != "cpu":
            fail("control", "checkpoint is not a CPU copy")
        ctl.step({"tau": 0.05})
        sa, oa = ctl.step()
        ctl.restore(snap)
        if ctl.state.engine.sent.device.type != self.dev.type:
            fail("control", "restore did not move the state to the card")
        ctl.step({"tau": 0.05})
        sb, ob = ctl.step()
        if sa.tick != sb.tick or not all(
                torch.equal(x, y) for x, y in zip(sa.engine, sb.engine)):
            fail("control", "restore + replay differs")
        tuned = float(ctl.knobs.sym.tau)
        say("control", f"tau retuned to {tuned:.2f} at tick 640; rewind to "
                       f"the tick-640 checkpoint replays ticks 640-1920 bit "
                       f"for bit (alpha max {oa.stats.alpha_max:.0f}, queue "
                       f"max {oa.stats.qmax:.0f} B)")

    # -------------------------------------------------------- 12. timing
    def timing(self):
        torch, K, Rf, Wn, Tl = self.torch, self.K, self.Rf, self.Wn, self.Tl
        from repro_torch.core.netsim.stages import stage_starts
        from repro_torch.kernels.netsim_tick.ops import (tick_operands,
                                                         tiled_operands)
        for shape in ("table1", "multipod128", "multipod512"):
            big = shape == "multipod512"
            ctx, ecfg, state, tick = self.mid_state(shape, True)
            # -- single tick
            starts = stage_starts(ctx, state, tick)
            args, kw = tick_operands(ctx, ecfg, starts, state, tick)
            saved = K.netsim_tick.launches
            k_dev, k_wall = timed(lambda: K.netsim_tick(*args, **kw),
                                  5 if big else 100, torch)
            K.netsim_tick.launches = saved
            p_dev, p_wall = timed(lambda: Rf.hot_tick(*args, **kw),
                                  3 if big else 30, torch)
            out = Rf.hot_tick(*args, **kw)
            # bytes the timed mode must move: every operand it reads once
            # and every output once.  With per-step ECMP the routes come
            # from the candidate table, so the static routes (arg 10) are
            # not read.
            nbytes = tensor_bytes(a for i, a in enumerate(args)
                                  if i != 10) + tensor_bytes(out)
            B, FW = args[0].shape
            H = ctx.H
            # float operations this run's data needs: ~30 per instance
            # plus 5 adds per (instance, hop) entry of the link and
            # Symphony sums
            ops = B * FW * (30 + 5 * H)
            self.report(shape, "netsim_tick", "netsim_tick.cu",
                        "src/repro/kernels/netsim_tick/kernel.py:339",
                        k_dev, k_wall, p_dev, p_wall, nbytes, ops, 1)
            # -- tiled tick
            blk = BLK[shape]
            args, kw = tiled_operands(ctx, ecfg, starts, state, tick, blk)
            saved = Tl.netsim_tiled.launches
            k_dev, k_wall = timed(lambda: Tl.netsim_tiled(*args, **kw), 20,
                                  torch)
            Tl.netsim_tiled.launches = saved
            p_dev, p_wall = timed(lambda: Rf.tiled_tick_ref(*args, **kw),
                                  3 if big else 10, torch)
            out = Rf.tiled_tick_ref(*args, **kw)
            tb = args[19]
            # per-step ECMP reads one candidate row (links and domains) of
            # every instance, its path count and one chunk size
            nbytes = (tensor_bytes(a for i, a in enumerate(args) if i != 19)
                      + 4 * B * FW * (2 * H + 2) + tensor_bytes(out))
            self.report(shape, "netsim_tiled", "netsim_tiled.cu",
                        "src/repro/kernels/netsim_tick/kernel.py:374",
                        k_dev, k_wall, p_dev, p_wall, nbytes, ops, 1,
                        note=f"blk={blk}, {-(-FW // blk)} blocks")
            # -- window of 20 ticks
            n = 20
            saved = Wn.netsim_window.launches
            k_dev, k_wall = timed(
                lambda: Wn.netsim_window(ctx, ecfg, state, tick, n),
                2 if big else 20, torch)
            Wn.netsim_window.launches = saved
            p_dev, p_wall = timed(
                lambda: Rf.window_ref(ctx, ecfg, state, tick, n),
                1 if big else 2, torch)
            new, smp = Rf.window_ref(ctx, ecfg, state, tick, n)
            iscal, fscal = Wn.window_operands(ctx, ecfg)
            st, wl = ctx.st, ctx.wl
            operands = (list(state) + [getattr(wl, f) for f in Wn._WL_FIELDS]
                        + [getattr(ctx, f) for f in Wn._CTX_FIELDS]
                        + [getattr(st, f) for f in Wn._STATIC_FIELDS]
                        + [iscal, fscal])
            nbytes = tensor_bytes(operands) + tensor_bytes(new) + \
                tensor_bytes(smp)
            # float operations per instance and tick: the hot stages (~30
            # + 5 per hop), marking (~12 per hop + 4), progress and DCQCN
            # (~20), the threefry draw (~90 integer operations per pair of
            # instances on a CC epoch)
            cc = int(ecfg.cc_periods[0])
            ops_w = n * B * FW * (54 + 17 * H + 45 / cc)
            self.report(shape, "netsim_window", "netsim_window.cu",
                        "src/repro/kernels/netsim_tick/window.py:64",
                        k_dev, k_wall, p_dev, p_wall, nbytes, ops_w, n)
        # -- switch pipeline: 8,000 packets, then the main path's 1,000,000
        Sp = self.Sp
        for P, seed in ((8000, 7), (1_000_000, 11)):
            trace = self.switch_trace(P, seed)
            saved = Sp.switch_pipeline.launches
            k_dev, k_wall = timed(lambda: Sp.switch_pipeline(*trace),
                                  20 if P < 10**5 else 3, torch)
            Sp.switch_pipeline.launches = saved
            # the plain version walks the state block on the host: its
            # cost is the wall time of one call
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            Sp.pipeline_plain(*trace)
            b.record()
            torch.cuda.synchronize()
            p_wall = a.elapsed_time(b)
            # 20 bytes in and 16 out per packet and the 64-byte LUT; ~20
            # float operations per packet on the exact path
            self.report(f"P={P}", "switch_pipeline", None,
                        "src/repro/kernels/switch_pipeline/kernel.py:42",
                        k_dev, k_wall, p_wall, p_wall, 36 * P + 64,
                        20 * P, 1, note="(plain version: wall time; its "
                                        "state walk runs on the host)")

    def report(self, shape, name, src, replaces, k_dev, k_wall, p_dev,
               p_wall, nbytes, ops, n, note=""):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        per_tick = f", {k_dev / n:.4f} ms/tick" if n > 1 else ""
        say("timing", f"{name} {shape}{' ' + note if note else ''}: kernel "
                      f"{k_dev:.4f} ms/launch on the device{per_tick} "
                      f"({k_wall:.4f} ms wall per call), plain version "
                      f"{p_dev:.4f} ms device ({p_wall:.4f} ms wall), bound "
                      f"{bound:.6f} ms ({nbytes} bytes: {bytes_ms:.6f} ms; "
                      f"{ops:.0f} ops: {ops_ms:.6f} ms), card {self.card}")
        if shape == MAIN_SHAPE[name]:
            pkg = "switch_pipeline" if name == "switch_pipeline" \
                else "netsim_tick"
            self.reports.append(dict(
                name=name, route="cuda",
                source=f"src/repro_torch/kernels/{pkg}/csrc/"
                       f"{src or name + '.cu'}",
                replaces=replaces, launches=self.launches.get(name, 0),
                max_abs_err=self.max_err[name], ms=k_dev, plain_ms=p_dev,
                bound_ms=bound,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None))

    # ------------------------------------------------------- 13. profile
    def profile(self):
        torch, T = self.torch, self.T
        from repro_torch.core.netsim.simulator import _window_body
        topo, wl, cfg = table1(T)
        n_run = 2000
        for tw in (1, 20):
            t1cfg = cfg._replace(n_ticks=n_run, sym_on=True, backend="cuda",
                                 tick_window=tw)
            torch.cuda.synchronize()
            t0 = time.time()
            t1 = T.simulate(topo, wl, t1cfg, routing="ecmp", seed=3,
                            device=self.dev)
            torch.cuda.synchronize()
            self.rates[("table1", tw)] = n_run / (time.time() - t0)
            if not torch.isfinite(t1.ts_throughput).all() or \
                    t1.ts_throughput.shape[0] != n_run // cfg.record_every:
                fail("profile", "Table-1 simulate returned malformed series")
        # where a main-path tick's time goes: ticks 300-499 alone (300-399
        # at 512 hosts)
        runs = (("table1", 1, None), ("table1", 20, None),
                ("multipod128", 20, None),
                ("multipod512", 1, BLK["multipod512"]),
                ("multipod512", 20, None))
        for shape, tw, blk in runs:
            topo, wl, cfg = SHAPES[shape](T)
            seeds = [3] if shape == "table1" else list(range(8))
            pcfg = cfg._replace(sym_on=True, backend="cuda", tick_window=tw,
                                blk=blk, segsum="onehot" if blk else "scatter")
            ctx, ecfg, sim = T.make_lanes(
                topo, wl, pcfg.structure(), pcfg.knobs(), seeds=seeds,
                device=self.dev)
            sim, _ = _window_body(ctx, ecfg, sim, 300)
            n_prof = 100 if shape == "multipod512" else 200
            wall_us, by_name = profile_ticks(
                lambda: _window_body(ctx, ecfg, sim, n_prof), torch)
            busy = sum(t for _, t in by_name.values())
            n_k = sum(n for n, _ in by_name.values())
            say("profile", f"{shape}, {ctx.B} lane(s), tick_window={tw}, "
                           f"blk={blk}, ticks 300-{299 + n_prof}: "
                           f"{wall_us / n_prof / 1e3:.3f} ms/tick wall, "
                           f"device busy {busy / n_prof / 1e3:.3f} ms/tick "
                           f"({100 * busy / wall_us:.1f}% busy), "
                           f"{n_k / n_prof:.2f} device kernels/tick")
            top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
            for name, (n, t) in top:
                say("profile", f"  {t / n_prof / 1e3:.4f} ms/tick  "
                               f"{n / n_prof:.2f}/tick  {name[:80]}")
        r = self.rates
        say("profile", "main path (ticks/s, set-up included, not profiled): "
                       f"Table 1 1 lane through simulate {r[('table1', 1)]:.1f}"
                       f" (tick_window=1), {r[('table1', 20)]:.1f} "
                       "(tick_window=20); 128 hosts 8 lanes "
                       f"{r.get(('multipod128', 1), 0):.1f} (tick_window=1), "
                       f"{r.get(('multipod128', 20), 0):.1f} "
                       f"(tick_window=20); 512 hosts 8 lanes "
                       f"{r.get(('multipod512', 1), 0):.1f} (tiled, "
                       f"tick_window=1), {r.get(('multipod512', 20), 0):.1f}"
                       f" (tick_window=20); card {self.card}")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    phases = list(argv) or list(PHASES)
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}; have {PHASES}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch)
    t_all = time.time()
    for p in PHASES:
        if p in phases:
            t0 = time.time()
            getattr(smoke, p)()
            say(p, f"phase done in {time.time() - t0:.1f} s")
    say("all", f"{len(phases)} phases in {time.time() - t_all:.1f} s")
    if phases != list(PHASES):
        return 0
    print(json.dumps({"kernels": smoke.reports}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
