#!/usr/bin/env python3
"""Where the tick and window kernels spend a tick, phase by phase, on one
CUDA card.

Builds a copy of ``src/repro_torch/kernels/netsim_tick/csrc`` (under the
git-ignored ``build/chip_phases``) in which thread 0 of block 0 records
``clock64()`` after each block-wide synchronisation of ``hot_tick`` and of
the window kernel's tick loop, runs both kernels on the mid-run states of
``chip_smoke.py`` (Table 1 x 4 lanes, 128 and 512 hosts x 8 lanes, 300
eager ticks first) and prints, per shape, each kernel's device time per
launch (CUDA events, as ``chip_smoke.py`` *timing* takes it) and the cycles
between the marks: the single tick's phases, and the last tick of a
20-tick window, both its own stages and its hot stages.  The marks add a
store per phase; the times printed are of the marked kernels.  Run from
the repository root:

    python3 chip_phases.py
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src/repro_torch/kernels/netsim_tick/csrc"
OUT = ROOT / "build/chip_phases"
MARK = ("__device__ long long nt_marks[64];\n#define NT_MARK(k) do { if "
        "(threadIdx.x == 0 && blockIdx.x == 0) nt_marks[k] = clock64(); } "
        "while (0)\n")
READ = ('\nextern "C" int netsim_marks_read(long long* o) { return (int)'
        'cudaMemcpyFromSymbol(o, nt_marks, sizeof(nt_marks)); }\n')
WIN0 = 16   # the window's marks follow hot_tick's


def _mark_after_syncs(text: str, indent: str, first: int,
                      after: tuple[str, ...]) -> tuple[str, int]:
    """Insert NT_MARK(k) after each line that starts with one of ``after``
    and after every ``__syncthreads();`` at ``indent`` (the syncs of the
    whole block); returns the text and the next k."""
    out, k = [], first
    for line in text.split("\n"):
        out.append(line)
        if line.startswith(after) or line == f"{indent}__syncthreads();":
            out.append(f"{indent}NT_MARK({k});")
            k += 1
    return "\n".join(out), k


def patch() -> tuple[int, int]:
    """The marked copy of the sources; returns (hot_tick's marks, the
    window loop's last mark + 1)."""
    OUT.mkdir(parents=True, exist_ok=True)
    for f in SRC.glob("*.cu*"):
        shutil.copy(f, OUT / f.name)
    h = (OUT / "netsim_hot.cuh").read_text()
    h = h.replace("#define NT_BIG", MARK + "#define NT_BIG", 1)
    i = h.index("__device__ __forceinline__ void hot_tick(")
    body, n_hot = _mark_after_syncs(
        h[i:], "  ", 0, ("  const float dt = d.dt, mtu = d.mtu;",
                         "  block_offsets(m.scur_s"))
    body = body.rstrip()
    assert body.endswith("}")
    body = body[:-1] + f"  __syncthreads();\n  NT_MARK({n_hot});\n}}\n"
    (OUT / "netsim_hot.cuh").write_text(h[:i] + body)
    w = (OUT / "netsim_window.cu").read_text()
    i0 = w.index("  for (int t = 0; t < a.n; ++t) {")
    i1 = w.index("  // ---- write back the Symphony rows")
    loop, n_win = _mark_after_syncs(w[i0:i1], "    ", WIN0,
                                    ("  for (int t = 0; t < a.n; ++t) {",))
    (OUT / "netsim_window.cu").write_text(w[:i0] + loop + w[i1:] + READ)
    t = (OUT / "netsim_tick.cu").read_text()
    (OUT / "netsim_tick.cu").write_text(t + READ)
    return n_hot + 1, n_win


def build(K, _build) -> dict:
    """Compile both marked libraries in parallel; load and bind them."""
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
         str(OUT / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name in ("netsim_tick", "netsim_window")}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the marked {name}.cu:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        K.LIBRARIES[name](lib)
        lib.netsim_marks_read.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    return libs


def intervals(torch, lib, first: int, last: int) -> list[int]:
    buf = (ctypes.c_longlong * 64)()
    torch.cuda.synchronize()
    if lib.netsim_marks_read(buf) != 0:
        raise SystemExit("reading the marks failed")
    return [buf[k + 1] - buf[k] for k in range(first, last - 1)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as C
    from repro_torch.core.netsim.stages import stage_starts
    from repro_torch.kernels import _build
    from repro_torch.kernels.netsim_tick import kernel as K
    from repro_torch.kernels.netsim_tick import window as Wn
    from repro_torch.kernels.netsim_tick.ops import tick_operands
    n_hot, n_win = patch()
    libs = build(K, _build)
    K.build = lambda name="netsim_tick": (libs[name], "")
    Wn.build = lambda name="netsim_window": (libs[name], "")
    smoke = C.Smoke(torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or "nvidia-smi unavailable", flush=True)
    # the hot phases between the marks; with both row sorts in phase 3 (as
    # at these states) phase 5 has no sync of its own
    hot = ("phase 0", "phase 1", "phase 2 + scans", "row placement",
           "link rows", "phase 4", "Symphony rows")
    win = ("starts 1", "starts 2", "hot stages", "marking + DCQCN",
           "progress", "segments 1", "segments 2")
    for shape in ("table1", "multipod128", "multipod512"):
        ctx, ecfg, state, tick = smoke.mid_state(shape, True)
        starts = stage_starts(ctx, state, tick)
        args, kw = tick_operands(ctx, ecfg, starts, state, tick)
        tick_ms, _ = C.timed(lambda: K.netsim_tick(*args, **kw), 20, torch)
        d = intervals(torch, libs["netsim_tick"], 0, n_hot)
        win_ms, _ = C.timed(
            lambda: Wn.netsim_window(ctx, ecfg, state, tick, 20), 5, torch)
        w = intervals(torch, libs["netsim_window"], WIN0, n_win)
        h = intervals(torch, libs["netsim_window"], 0, n_hot)
        print(f"{shape}: tick kernel {tick_ms:.4f} ms a launch, cycles "
              + ", ".join(f"{n} {c}" for n, c in zip(hot, d))
              + f" (total {sum(d)})", flush=True)
        print(f"{shape}: window kernel {win_ms:.4f} ms per 20 ticks, last "
              "tick's cycles " + ", ".join(f"{n} {c}" for n, c in zip(win, w))
              + "; its hot stages " + ", ".join(
                  f"{n} {c}" for n, c in zip(hot, h)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
