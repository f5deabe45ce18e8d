#!/usr/bin/env python3
"""Where a launch cell's peak device memory goes on one CUDA card.

Builds h2o-danube-3-4b's ``train_4k`` cell at depth 2 on one rank of a
(data 16, model 1) mesh (``launch/steps.py`` ``build_cell``: 16 x 4,096
tokens, accum 2; the rank's share of the args drawn on the card from seed
0) and runs one step of it plainly, then one under
``torch.utils.flop_counter.FlopCounterMode``, each from freshly drawn args.
For each it prints the peak allocated above the args beside the dry-run's
prediction (``launch/dryrun.py``'s ``measure`` on meta tensors); then the
allocations live at the counted step's peak, grouped by the innermost
``repro_torch`` frame that allocated them (``torch.cuda.memory`` history;
``?`` for allocations made outside any such frame, as the autograd
engine's device thread makes them in the backward).

    python3 chip_memory.py        # ~35 s of command on the card

It needs one CUDA card; without one it exits non-zero before printing any
result.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def frame_of(frames: list) -> str:
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" in name:
            return (f"{name.split('repro_torch/')[-1]}:{f.get('line')} "
                    f"{f.get('name')}")
    return "?"


def live_at_peak(trace: list) -> dict:
    """{frame: [bytes, count]} of the allocations live when the trace's
    allocated total peaked."""
    live, cur, best, at = {}, 0, -1, 0
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            cur += e["size"]
            if cur > best:
                best, at = cur, i
        elif e["action"] == "free_completed" and e["addr"] in live:
            cur -= live.pop(e["addr"])
    live = {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], frame_of(e.get("frames", [])))
        elif e["action"] == "free_completed" and e["addr"] in live:
            live.pop(e["addr"])
    groups: dict = collections.defaultdict(lambda: [0, 0])
    for size, fr in live.values():
        groups[fr][0] += size
        groups[fr][1] += 1
    return dict(groups)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_memory: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.dryrun import measure, rank_share
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (build_cell, make_train_config,
                                          materialize)
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    meta = make_mesh((16, 1), ("data", "model"), ["meta"] * 16)
    pred = measure(build_cell("h2o_danube_3_4b", "train_4k", meta,
                              depth_override=2))["memory"]
    mesh = make_mesh((16, 1), ("data", "model"), [dev] * 16)
    cell = build_cell("h2o_danube_3_4b", "train_4k", mesh, depth_override=2)
    warm = make_train_config(cell.arch, cell.shape).warmup_steps
    groups = {}
    for counted in (False, True):
        args = materialize(cell, rank_share(cell), dev, seed=0)
        args[1].step.fill_(warm)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if counted:
            torch.cuda.memory._record_memory_history(
                max_entries=3_000_000, stacks="python")
        with FlopCounterMode(display=False) if counted else \
                contextlib.nullcontext():
            cell.fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if counted:
            groups = live_at_peak(
                torch.cuda.memory._snapshot()["device_traces"][0])
            torch.cuda.memory._record_memory_history(enabled=None)
        print(f"{'under FlopCounterMode' if counted else 'plain'}: peak "
              f"{peak / 2**30:.3f} GiB above the args, the dry-run's temp "
              f"{pred['temp'] / 2**30:.3f} GiB "
              f"({peak / pred['temp'] - 1:+.1%})", flush=True)
        del args
        gc.collect()
    print("live at the counted step's peak, by allocating frame:")
    for fr, (n, c) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {n / 2**30:8.3f} GiB {c:5d}  {fr}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
