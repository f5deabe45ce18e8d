#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Drives the port's main path — the fluid network simulator with the fused
netsim tick in a hand-written CUDA kernel — phase by phase, one line per
phase, and exits non-zero at the first phase that fails:

1. build    compile the kernel from the checkout (nvcc, sm_90a); print the
            card's name and power limit from nvidia-smi
2. kernel   the kernel against its plain torch version on the card, on
            mid-run states (500 eager ticks first) at the Table-1 shape and
            the 128-host fat_tree_multipod shape (8 lanes), sym_on/pq_on
            on and off (as lanes) and per_step_ecmp on and off
3. goldens  Table 1, 20,000 ticks, seed 3, through backend="cuda": the
            ecmp_base and ecmp_sym golden finish ticks (two lanes of one
            grid run), with one kernel launch per tick
4. multipod 128-host fat_tree_multipod, 8 seeds as lanes, 2,000 ticks:
            backend="cuda" (the main-path run whose launches are counted)
            against backend="eager", integer results equal
5. timing   kernel time per launch against the plain version's, at both
            shapes (device time from the profiler, and wall time per
            call)
6. profile  main-path ticks/s at Table 1 with 1 lane through ``simulate``,
            and where one tick's time goes: wall and device-busy time, the
            busiest kernels

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:

    python3 chip_smoke.py

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
# Kernel and plain version add every float sum in the same order and
# without fused multiply-adds, so they should agree to the bit; the
# tolerance admits a few ulps (float32 ulp ~ 6e-8 relative) and no more.
RTOL = 1e-6


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
    for _ in range(5):
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core.netsim as T
    from repro_torch.core.netsim.stages import (engine_tick_eager,
                                                ordered_segment_sum,
                                                stage_starts)
    from repro_torch.kernels.netsim_tick import kernel as K
    from repro_torch.kernels.netsim_tick import ref as Rf
    from repro_torch.kernels.netsim_tick.ops import tick_operands

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------- 1. build
    t0 = time.time()
    _, log = K.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            say("build", line.strip())
    say("build", f"netsim_tick built in {time.time() - t0:.1f} s")
    print(card, flush=True)

    # ordered float segment sum on the card vs the CPU (np.add.at order)
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 97, (2, 8192), generator=g)
    vals = torch.rand(2, 8192, generator=g) * 1e9
    base = torch.rand(2, 97, generator=g)
    same = torch.equal(ordered_segment_sum(base, idx, vals),
                       ordered_segment_sum(base.to(dev), idx.to(dev),
                                           vals.to(dev)).cpu())
    if not same:
        fail("build", "ordered_segment_sum on the card differs from the "
                      "CPU order")
    say("build", "ordered_segment_sum on the card equals the CPU order")

    # --------------------------------------------- 2. kernel vs plain
    max_err = 0.0
    # lanes: the four (sym_on, pq_on) knob points x 1 seed (Table 1) or
    # x 2 seeds (128 hosts, 8 lanes)
    shapes = {"table1": (table1(T), [0]), "multipod128": (multipod128(T),
                                                          [0, 1])}
    kernel_case = {}
    for shape, ((topo, wl, cfg), seeds) in shapes.items():
        for ecmp in (True, False):
            routing = "ecmp" if ecmp else "ecmp_flow"
            ctx, ecfg, sim = T.make_lanes(
                topo, wl, cfg.structure(), lane_knobs(T, cfg), seeds=seeds,
                routing=routing, device=dev)
            state = sim.engine
            with torch.no_grad():
                for tick in range(500):
                    state, _ = engine_tick_eager(ctx, ecfg, state, tick, False)
                for tick in range(500, 520):
                    starts = stage_starts(ctx, state, tick)
                    args, kw = tick_operands(ctx, ecfg, starts, state, tick)
                    out = K.netsim_tick(*args, **kw)
                    ref = Rf.hot_tick(*args, **kw)
                    torch.cuda.synchronize()
                    for f in out._fields:
                        x, y = getattr(out, f), getattr(ref, f)
                        if x.dtype == torch.int32:
                            if not torch.equal(x, y):
                                fail("kernel", f"{shape} ecmp={ecmp} tick "
                                     f"{tick}: {f} differs")
                        else:
                            err = (x - y).abs().max().item()
                            max_err = max(max_err, err)
                            if not torch.allclose(x, y, rtol=RTOL, atol=0.0):
                                fail("kernel", f"{shape} ecmp={ecmp} tick "
                                     f"{tick}: {f} max abs err {err}")
                    state, _ = engine_tick_eager(ctx, ecfg, state, tick, False)
            active = int((starts.step_of >= 0).sum())
            say("kernel", f"{shape} lanes={ctx.B} per_step_ecmp={ecmp}: "
                          f"ticks 500-519 equal (ints exact, floats rtol "
                          f"{RTOL}); {active} occupied instances")
            if ecmp:
                kernel_case[shape] = (args, kw)
    say("kernel", f"max abs float error kernel vs plain: {max_err}")

    # ------------------------------------------------------- 3. goldens
    # ecmp_base and ecmp_sym as the two lanes of one grid run
    topo, wl, cfg = table1(T)
    knobs = T.stack_knobs([cfg.knobs(), cfg._replace(sym_on=True).knobs()])
    K.netsim_tick.launches = 0
    t0 = time.time()
    res = T.simulate_grid(topo, wl, cfg._replace(backend="cuda").structure(),
                          knobs, seeds=[3], routing="ecmp", device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    n = K.netsim_tick.launches
    if n != cfg.n_ticks:
        fail("goldens", f"{n} kernel launches for {cfg.n_ticks} ticks")
    for k, name in enumerate(("ecmp_base", "ecmp_sym")):
        job = int(res.job_finish_ticks[k, 0, 0])
        flows = res.finish_ticks[k, 0].cpu().tolist()
        if job != GOLDEN_JOB[name] or flows != GOLDEN_FLOWS[name]:
            fail("goldens", f"{name}: job finish {job}, flows {flows}")
        say("goldens", f"{name}: job finish {job} and all 32 flow finish "
                       "ticks equal the goldens")
    say("goldens", f"2 lanes x {cfg.n_ticks} ticks, {n} launches, "
                   f"{cfg.n_ticks / secs:.1f} ticks/s")

    # ---------------------------------------------- 4. 128-host, 8 lanes
    topo, wl, cfg = multipod128(T)
    seeds = list(range(8))
    eager = T.simulate_seeds(topo, wl, cfg._replace(sym_on=True), "ecmp",
                             seeds, device=dev)
    torch.cuda.synchronize()
    K.netsim_tick.launches = 0                       # main path starts
    t0 = time.time()
    fused = T.simulate_seeds(topo, wl, cfg._replace(sym_on=True,
                                                    backend="cuda"),
                             "ecmp", seeds, device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    main_launches = K.netsim_tick.launches           # main path ends
    if main_launches != cfg.n_ticks:
        fail("multipod", f"{main_launches} launches for {cfg.n_ticks} ticks")
    for f in ("finish_ticks", "job_finish_ticks", "ts_min_wire",
              "ts_max_wire", "ts_done_min", "ts_alpha_max"):
        if not torch.equal(getattr(eager, f), getattr(fused, f)):
            fail("multipod", f"cuda and eager differ in {f}")
    tput_err = (eager.ts_throughput - fused.ts_throughput).abs().max().item()
    if not torch.isfinite(fused.ts_throughput).all() or \
            not torch.allclose(eager.ts_throughput, fused.ts_throughput,
                               rtol=1e-5):
        fail("multipod", f"throughput series differ: {tput_err}")
    done = fused.ts_done_min[:, -1, 0].tolist()
    mp_rate = cfg.n_ticks / secs
    say("multipod", f"8 lanes x {cfg.n_ticks} ticks: cuda == eager on "
                    f"integer results (throughput max abs diff {tput_err}); "
                    f"steps done per lane {done}; {main_launches} launches; "
                    f"{mp_rate:.1f} ticks/s ({mp_rate * 8:.1f} lane-ticks/s)")

    # --------------------------------------------------------- 5. timing
    report = None
    for shape in ("table1", "multipod128"):
        args, kw = kernel_case[shape]
        saved = K.netsim_tick.launches
        k_dev, k_wall = timed(lambda: K.netsim_tick(*args, **kw), 100, torch)
        K.netsim_tick.launches = saved
        p_dev, p_wall = timed(lambda: Rf.hot_tick(*args, **kw), 30, torch)
        if k_dev is None or p_dev is None:
            fail("timing", "the profiler saw no device time")
        out = Rf.hot_tick(*args, **kw)
        # bytes the timed mode must move: every operand it reads once and
        # every output once.  With per-step ECMP the routes come from the
        # candidate table, so the static routes (arg 10) are not read;
        # without it the candidate table and fan-out (args 11, 12) are not.
        unread = {10} if kw["per_step_ecmp"] else {11, 12}
        nbytes = tensor_bytes(a for i, a in enumerate(args)
                              if i not in unread) + tensor_bytes(out)
        B, FW = args[0].shape
        H = args[10].shape[-1]
        # float operations this run's data needs: ~30 per instance plus 5
        # adds per (instance, hop) entry of the link and Symphony sums
        ops = B * FW * (30 + 5 * H)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        say("timing", f"{shape} lanes={B}: kernel {k_dev:.4f} ms/launch on "
                      f"the device ({k_wall:.4f} ms wall per call), plain "
                      f"version {p_dev:.4f} ms device ({p_wall:.4f} ms "
                      f"wall), bound {bound:.6f} ms ({nbytes} bytes), "
                      f"card {card}")
        report = dict(name="netsim_tick", route="cuda",
                      source="src/repro_torch/kernels/netsim_tick/csrc/"
                             "netsim_tick.cu",
                      replaces="src/repro/kernels/netsim_tick/kernel.py:339",
                      launches=main_launches, max_abs_err=max_err,
                      ms=k_dev, plain_ms=p_dev, bound_ms=bound,
                      bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                      library_ms=None)
    # -------------------------------------------------------- 6. profile
    # main-path ticks/s at Table 1 with 1 lane, through the entry point a
    # user calls (set-up, sample cadence and stacking included)
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    topo, wl, cfg = table1(T)
    n_run = 2000
    t1cfg = cfg._replace(n_ticks=n_run, sym_on=True, backend="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    t1 = T.simulate(topo, wl, t1cfg, routing="ecmp", seed=3, device=dev)
    torch.cuda.synchronize()
    t1_rate = n_run / (time.time() - t0)
    if not torch.isfinite(t1.ts_throughput).all() or \
            t1.ts_throughput.shape[0] != n_run // cfg.record_every:
        fail("profile", "Table-1 simulate returned malformed series")
    # where a main-path tick's time goes: the same ticks by hand, so that
    # the profiler sees ticks 300-499 alone
    ctx, ecfg, sim = T.make_lanes(topo, wl, t1cfg.structure(),
                                  t1cfg.knobs(), seeds=[3], device=dev)
    state, n_prof, R = sim.engine, 200, cfg.record_every
    with torch.no_grad():
        for tick in range(300):
            state, _ = T.stages.engine_tick(ctx, ecfg, state, tick,
                                            tick % R == R - 1)
        torch.cuda.synchronize()
        tick0 = 300
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for tick in range(tick0, tick0 + n_prof):
                state, _ = T.stages.engine_tick(ctx, ecfg, state, tick,
                                                tick % R == R - 1)
            torch.cuda.synchronize()
            wall_us = (time.time() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    busy = sum(t for _, t in by_name.values())
    n_kernels = sum(n for n, _ in by_name.values())
    say("profile", f"Table 1, 1 lane, cuda backend, {n_prof} ticks: "
                   f"{wall_us / n_prof / 1e3:.3f} ms/tick wall, device busy "
                   f"{busy / n_prof / 1e3:.3f} ms/tick "
                   f"({100 * busy / wall_us:.1f}% busy), "
                   f"{n_kernels / n_prof:.1f} device kernels/tick")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (n, t) in top:
        say("profile", f"  {t / n_prof / 1e3:.4f} ms/tick  {n / n_prof:.1f}"
                       f"/tick  {name[:90]}")
    say("profile", f"main path: Table 1 1 lane {t1_rate:.1f} ticks/s "
                   f"(simulate, {n_run} ticks, set-up included, not "
                   f"profiled); 128 hosts 8 lanes {mp_rate:.1f} ticks/s")

    print(json.dumps({"kernels": [report]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
