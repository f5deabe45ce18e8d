#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Drives the port's main paths — the fluid network simulator with the fused
netsim tick (``backend="cuda"``, ``tick_window=1``) and with the multi-tick
window kernel (``tick_window > 1``), and the online controller on top of it
— phase by phase, one line per phase, and exits non-zero at the first phase
that fails:

1. build    compile both kernel libraries from the checkout (one nvcc per
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
5. goldens  Table 1, 20,000 ticks, seed 3: the ecmp_base and ecmp_sym golden
            finish ticks (two lanes of one grid run) through
            backend="cuda" with tick_window 1 (one tick launch per tick),
            20 (1,000 window launches) and 7 (3,000)
6. multipod 128-host fat_tree_multipod, 8 seeds as lanes, 2,000 ticks:
            backend="cuda" with tick_window 1 and 20 (the main-path runs
            whose launches are counted) against backend="eager"
7. control  SimController on the card (Table 1, window_ticks=640,
            tick_window=20): stepping equals one-shot simulate, tau retuned
            mid-run, checkpoint/restore replays bit for bit
8. timing   each kernel's device time per launch against its plain
            version's and its bound, at both shapes
9. profile  main-path ticks/s (Table 1 with 1 lane through ``simulate``,
            and 128 hosts x 8 lanes) with tick_window 1 and 20, and where a
            tick's time goes: wall and device-busy time, the busiest kernels

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py build window # a subset (no report lines)

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
PHASES = ("build", "math", "kernel", "window", "goldens", "multipod",
          "control", "timing", "profile")
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


def multipod128(T):
    """benchmarks/grid512.py's full configuration at 128 hosts: 4 pods of
    4 ToRs x 8 hosts, 4 spines per pod, 8 cores at 1:2 oversubscription,
    rings of 32, 8 MB chunks, coarse 20 us ticks."""
    topo = T.make_fat_tree(4, 4, 4, 8, 8, core_oversubscription=2.0)
    b = T.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(128)), ring_size=32, chunk_bytes=8e6,
                   passes=1, barrier=False)
    cfg = T.SimParams(n_ticks=2000, window=64, dt=20e-6, sym_win_ticks=5,
                      cc_epoch_ticks=2)
    return topo, b.build(), cfg


def lane_knobs(T, cfg):
    """The four knob points (sym_on, pq_on) in {0,1}^2."""
    return T.stack_knobs([
        cfg._replace(sym_on=bool(i % 2), pq_on=bool(i // 2)).knobs()
        for i in range(4)])


def tensor_bytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def timed(fn, n: int, torch) -> tuple[float, float]:
    """``(device ms, wall ms)`` per call of ``fn`` over ``n`` calls after a
    warm-up: device time is the sum of the CUDA kernels the profiler saw
    (None if it saw none); wall time is CUDA events around the loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    return (dev_us / n / 1e3 if dev_us else None), a.elapsed_time(b) / n


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
        from repro_torch.kernels.netsim_tick import window as Wn
        self.T, self.K, self.Rf, self.Wn = T, K, Rf, Wn
        self.dev = torch.device("cuda")
        self.card = "nvidia-smi unavailable"
        self.mid = {}           # (shape, ecmp) -> (ctx, cfg, state, tick)
        self.max_err = {"netsim_tick": 0.0, "netsim_window": 0.0}
        self.launches = {}
        self.rates = {}
        self.reports = []
        self.eager128 = None

    # ---------------------------------------------------------- 1. build
    def build(self):
        torch, K = self.torch, self.K
        t0 = time.time()
        libs = K.build_all()
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
        lanes: Table 1 x 1 seed, or 128 hosts x 2 seeds."""
        key = (shape, ecmp)
        if key not in self.mid:
            T, torch = self.T, self.torch
            from repro_torch.core.netsim.stages import engine_tick_eager
            (topo, wl, cfg), seeds = ((table1(T), [0]) if shape == "table1"
                                      else (multipod128(T), [0, 1]))
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

    # ------------------------------------------------------- 5. goldens
    def goldens(self):
        torch, T, K, Wn = self.torch, self.T, self.K, self.Wn
        topo, wl, cfg = table1(T)
        knobs = T.stack_knobs([cfg.knobs(),
                               cfg._replace(sym_on=True).knobs()])
        R = cfg.record_every
        # tick_window=1: a tick launch per tick; w > 1: each record period
        # runs R // w windows of w ticks and one of R % w
        for tw, want_tick, want_win in (
                (1, cfg.n_ticks, 0), (20, 0, cfg.n_ticks // R),
                (7, 0, cfg.n_ticks // R * -(-R // 7))):
            K.netsim_tick.launches = 0
            Wn.netsim_window.launches = 0
            t0 = time.time()
            res = T.simulate_grid(
                topo, wl, cfg._replace(backend="cuda",
                                       tick_window=tw).structure(),
                knobs, seeds=[3], routing="ecmp", device=self.dev)
            torch.cuda.synchronize()
            secs = time.time() - t0
            nt, nw = K.netsim_tick.launches, Wn.netsim_window.launches
            if (nt, nw) != (want_tick, want_win):
                fail("goldens", f"tick_window={tw}: {nt} tick and {nw} "
                                f"window launches for {cfg.n_ticks} ticks")
            for k, name in enumerate(("ecmp_base", "ecmp_sym")):
                job = int(res.job_finish_ticks[k, 0, 0])
                flows = res.finish_ticks[k, 0].cpu().tolist()
                if job != GOLDEN_JOB[name] or flows != GOLDEN_FLOWS[name]:
                    fail("goldens", f"tick_window={tw} {name}: job finish "
                                    f"{job}, flows {flows}")
            say("goldens", f"tick_window={tw}: ecmp_base {GOLDEN_JOB['ecmp_base']}"
                           f" and ecmp_sym {GOLDEN_JOB['ecmp_sym']} with all "
                           f"{len(flows)} flow finish ticks; 2 lanes x "
                           f"{cfg.n_ticks} "
                           f"ticks, {nt} tick + {nw} window launches, "
                           f"{cfg.n_ticks / secs:.1f} ticks/s")

    # ---------------------------------------------- 6. 128-host, 8 lanes
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

    # -------------------------------------------------------- 7. control
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

    # --------------------------------------------------------- 8. timing
    def timing(self):
        torch, K, Rf, Wn = self.torch, self.K, self.Rf, self.Wn
        from repro_torch.core.netsim.stages import stage_starts
        from repro_torch.kernels.netsim_tick.ops import tick_operands
        for shape in ("table1", "multipod128"):
            ctx, ecfg, state, tick = self.mid_state(shape, True)
            # -- single tick
            starts = stage_starts(ctx, state, tick)
            args, kw = tick_operands(ctx, ecfg, starts, state, tick)
            saved = K.netsim_tick.launches
            k_dev, k_wall = timed(lambda: K.netsim_tick(*args, **kw), 100,
                                  torch)
            K.netsim_tick.launches = saved
            p_dev, p_wall = timed(lambda: Rf.hot_tick(*args, **kw), 30, torch)
            if k_dev is None or p_dev is None:
                fail("timing", "the profiler saw no device time")
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
            # -- window of 20 ticks
            n = 20
            saved = Wn.netsim_window.launches
            k_dev, k_wall = timed(
                lambda: Wn.netsim_window(ctx, ecfg, state, tick, n), 20,
                torch)
            Wn.netsim_window.launches = saved
            p_dev, p_wall = timed(
                lambda: Rf.window_ref(ctx, ecfg, state, tick, n), 2, torch)
            if k_dev is None or p_dev is None:
                fail("timing", "the profiler saw no device time")
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
            ops = n * B * FW * (54 + 17 * H + 45 / cc)
            self.report(shape, "netsim_window", "netsim_window.cu",
                        "src/repro/kernels/netsim_tick/window.py:64",
                        k_dev, k_wall, p_dev, p_wall, nbytes, ops, n)

    def report(self, shape, name, src, replaces, k_dev, k_wall, p_dev,
               p_wall, nbytes, ops, n):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        per_tick = f", {k_dev / n:.4f} ms/tick" if n > 1 else ""
        say("timing", f"{name} {shape}: kernel {k_dev:.4f} ms/launch on the "
                      f"device{per_tick} ({k_wall:.4f} ms wall per call), "
                      f"plain version {p_dev:.4f} ms device ({p_wall:.4f} ms "
                      f"wall), bound {bound:.6f} ms ({nbytes} bytes: "
                      f"{bytes_ms:.6f} ms; {ops:.0f} ops: {ops_ms:.6f} ms), "
                      f"card {self.card}")
        if shape == "multipod128":       # the main path's shape
            self.reports.append(dict(
                name=name, route="cuda",
                source=f"src/repro_torch/kernels/netsim_tick/csrc/{src}",
                replaces=replaces, launches=self.launches.get(name, 0),
                max_abs_err=self.max_err[name], ms=k_dev, plain_ms=p_dev,
                bound_ms=bound,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None))

    # -------------------------------------------------------- 9. profile
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
        # where a main-path tick's time goes: ticks 300-499 alone
        shapes = {"table1": (table1(T), [3]),
                  "multipod128": (multipod128(T), list(range(8)))}
        for shape, ((topo, wl, cfg), seeds) in shapes.items():
            for tw in (1, 20):
                if shape == "multipod128" and tw == 1:
                    continue
                pcfg = cfg._replace(sym_on=True, backend="cuda",
                                    tick_window=tw)
                ctx, ecfg, sim = T.make_lanes(
                    topo, wl, pcfg.structure(), pcfg.knobs(), seeds=seeds,
                    device=self.dev)
                sim, _ = _window_body(ctx, ecfg, sim, 300)
                n_prof = 200
                wall_us, by_name = profile_ticks(
                    lambda: _window_body(ctx, ecfg, sim, n_prof), torch)
                busy = sum(t for _, t in by_name.values())
                n_k = sum(n for n, _ in by_name.values())
                say("profile", f"{shape}, {ctx.B} lane(s), tick_window={tw},"
                               f" ticks 300-499: {wall_us / n_prof / 1e3:.3f}"
                               f" ms/tick wall, device busy "
                               f"{busy / n_prof / 1e3:.3f} ms/tick "
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
                       f"(tick_window=20); card {self.card}")


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
