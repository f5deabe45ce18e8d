"""Multi-pod dry-run over meta tensors: every (architecture x input shape)
cell on the production meshes, sized and counted without a device.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell with XLA and reads its memory and cost analyses; the port runs
one rank's share of the cell's ``fn`` once on the meta device (shapes and
dtypes, no values, no allocation) and counts what it does:

* **Meshes** are the production meshes over meta devices
  (``make_production_mesh(multi_pod=..., devices=["meta"] * n)``).
* **A rank's share** (:func:`rank_share`): the batch axes of the inputs
  and the decode cache are split over ``(pod, data)`` as ``_batch_axes``
  places them.  The ``model`` axis is not partitioned in the program the
  port runs: GSPMD's partitioning is ROADMAP queue 1 item 1, left 6, not
  ported.  So on a mesh whose ``model`` axis is larger than 1 the rank's
  program runs at full model width (the MoE dispatches on one device):
  ``memory.temp`` is measured at that width, and the record says so
  (``temp_at_full_model_width``), and ``flops_per_device`` and
  ``bytes_per_device`` are the counts divided by the ``model`` axis size.
* ``memory.argument``: the exact per-device shard bytes of ``cell.args``
  under their shardings (each dimension over the product of its mesh axes,
  rounded up).
* ``memory.output`` and ``memory.alias``: the outputs of the meta run; an
  output that is a donated argument (the port updates those in place)
  counts that argument's shard bytes, and is aliased.
* ``memory.temp``: the peak of live bytes during the meta run, less the
  arguments and the new outputs, from a dispatch mode that follows each
  storage from its first op to its death, each rounded up to the CUDA
  caching allocator's 512 bytes.  ``per_device_total`` = argument +
  output - alias + temp, which at a ``model`` axis of 1 is the meta run's
  peak (less the rounding of the arguments and new outputs).
* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``'s
  count of the matrix products (forward and backward), every loop trip
  counted.  ``bytes_per_device``: every non-view op's input and output
  bytes (each op read and written once: an eager program without fusion).
* ``collectives`` and ``wire_bytes_per_device``: from the shardings, by the
  reference's per-kind ring formulas (``dryrun.py:79-86``): a train cell's
  gradient sync over its batch axes in ``flags.RING_SYNC_DTYPE`` (an
  all-reduce, or a reduce-scatter over the axes a leaf is already sharded
  on), and each MoE dispatch's ``all_to_all``s over ``model``
  (``_moe_chunk_ep``: tokens out, their expert ids, results back; in
  training also in the recompute and the backward).  Collectives that
  only GSPMD's tensor parallelism would add are left out and named in
  ``collectives_not_ported``.
* The roofline terms use the card's spec-sheet numbers (:data:`HARDWARE`):
  ``t_compute`` = flops / 989e12, ``t_memory`` = bytes / 3.35e12,
  ``t_collective`` = wire bytes / 450e9 (NVLink 4's 900 GB/s a GPU, both
  directions, halved: one direction), and ``memory.fits_h100`` holds the
  total against 80 GiB.

``--roofline`` keeps the reference's loop-free record: the cell under
``flags.ROOFLINE_MODE`` with ``accum`` 1 at depths of 1 and 2 layer
groups, extrapolated linearly to the full depth (eager counts need no
extrapolation; it is kept so that the two packages' records line up).

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m \\
      --shape decode_32k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --roofline

Results are kept per ``arch/shape/mesh`` in the output JSON (default
``dryrun_results_torch.json`` at the repository root, git-ignored);
finished cells are skipped on a re-run unless ``--force``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .. import flags
from ..configs import registry
from ..models.moe import DISPATCH_CHUNK
from ..models.params import ShapeDtypeStruct, shard_bytes, shard_shape
from .mesh import make_production_mesh
from .steps import Cell, _batch_axes, build_cell, materialize

__all__ = ["HARDWARE", "PEAK_FLOPS", "HBM_BW", "LINK_BW", "HBM_BYTES",
           "DEFAULT_OUT", "rank_share", "measure", "collectives", "run_cell",
           "memory_total", "main"]

DEFAULT_OUT = Path(__file__).resolve().parents[3] / \
    "dryrun_results_torch.json"

# NVIDIA H100 80GB HBM3 (SXM) spec sheet, at its 700 W power limit
HARDWARE = "NVIDIA H100 80GB HBM3, 700 W (spec sheet)"
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # bytes/s of HBM3
LINK_BW = 450e9              # bytes/s one direction: NVLink 4, 900 GB/s a
                             # GPU counting both directions
HBM_BYTES = 80 * 1024**3
ALLOC_BYTES = 512            # the CUDA caching allocator's rounding
BATCH_AXES = frozenset(("pod", "data"))
NOT_PORTED = ("tensor-parallel all-reduces and all-gathers over 'model' "
              "(GSPMD, ROADMAP queue 1 item 1, left 6)",
              "FSDP parameter all-gathers over 'data' (GSPMD, left 6)")


def _axes(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _structs(tree) -> list[ShapeDtypeStruct]:
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, ShapeDtypeStruct)]


def rank_share(cell: Cell) -> tuple:
    """The cell's abstract args as one rank holds them in the program the
    port runs: in the batch arguments (inputs, labels, decode cache) each
    dimension sharded over batch axes only ("pod", "data") is divided by
    their size; every other dimension is whole (the ``model`` axis is not
    partitioned)."""
    def share(s):
        if not isinstance(s, ShapeDtypeStruct) or s.sharding is None:
            return s
        sizes = s.sharding.mesh.shape
        shape = list(s.shape)
        for i, part in enumerate(s.sharding.spec):
            axes = _axes(part)
            if axes and set(axes) <= BATCH_AXES:
                shape[i] //= math.prod(sizes[a] for a in axes)
        return ShapeDtypeStruct(tuple(shape), s.dtype)
    return tuple(pytree.tree_map(share, a) if i in cell.batch_args else a
                 for i, a in enumerate(cell.args))


class LiveBytes(TorchDispatchMode):
    """Follows every storage an op returns from its birth to its death
    (``weakref.finalize`` on the storage), each rounded up to
    ``ALLOC_BYTES``: ``live`` now, ``peak`` so far; and ``accessed``, the
    input and output bytes of every op that is not a view."""

    def __init__(self):
        super().__init__()
        self.sizes: dict[int, int] = {}
        self.live = self.peak = self.accessed = 0

    def _gone(self, key: int, n: int) -> None:
        self.live -= n
        self.sizes.pop(key, None)

    def hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage from now on; its rounded bytes."""
        st = t.untyped_storage()
        key = st._cdata
        if key not in self.sizes:
            n = -(-st.nbytes() // ALLOC_BYTES) * ALLOC_BYTES
            self.sizes[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._gone, key, n)
        return self.sizes[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.accessed += sum(t.numel() * t.element_size()
                                 for t in ins + outs)
        for t in outs:
            self.hold(t)
        return out


@contextlib.contextmanager
def _one_rank(model):
    """The model as one rank runs it: no mesh, so that the MoE dispatches
    on one device and ``constrain`` is skipped."""
    mesh = model.mesh
    model.mesh = None
    try:
        yield
    finally:
        model.mesh = mesh


def memory_total(mem: dict) -> int:
    """argument + output - alias + temp: what one device holds at peak."""
    return mem["argument"] + mem["output"] - mem["alias"] + mem["temp"]


def measure(cell: Cell) -> dict:
    """One meta run of a rank's share of ``cell.fn``: flops, bytes
    accessed and the memory record (see the module docstring)."""
    mesh_tp = cell.model.tp
    share = rank_share(cell)
    args = materialize(cell, share, "meta")
    track = LiveBytes()
    held = sum(track.hold(t) for t in pytree.tree_leaves(args)
               if isinstance(t, torch.Tensor))
    donated = {}
    for i in cell.donate:
        for s, t in zip(_structs(cell.args[i]), pytree.tree_leaves(args[i])):
            donated[t.untyped_storage()._cdata] = shard_bytes(s)
    t0 = time.time()
    with _one_rank(cell.model), FlopCounterMode(display=False) as fc, track:
        out = cell.fn(*args)
    secs = time.time() - t0
    alias = new = new_held = 0
    seen = set()
    for t in pytree.tree_leaves(out):
        if not isinstance(t, torch.Tensor):
            continue
        key = t.untyped_storage()._cdata
        if key in seen:
            continue
        seen.add(key)
        if key in donated:
            alias += donated[key]
        else:
            new += t.numel() * t.element_size()
            new_held += track.sizes.get(key, 0)
    argument = sum(shard_bytes(s) for s in _structs(cell.args))
    mem = {"argument": argument, "output": alias + new, "alias": alias,
           "temp": track.peak - held - new_held}
    mem["per_device_total"] = memory_total(mem)
    mem["fits_h100"] = bool(mem["per_device_total"] <= HBM_BYTES)
    mem["temp_at_full_model_width"] = mesh_tp > 1
    return {"flops_per_device": fc.get_total_flops() / mesh_tp,
            "bytes_per_device": track.accessed / mesh_tp,
            "memory": mem, "meta_run_s": secs}


def _add(out: dict, kind: str, nbytes: float, n: int, count: int = 1):
    """One collective of ``nbytes`` operand bytes a device over a group of
    ``n``, ``count`` times, with the reference's ring wire bytes."""
    if n <= 1:
        return
    if kind == "all-reduce":
        wire = 2 * nbytes * (n - 1) / n
    else:           # reduce-scatter, all-to-all, all-gather
        wire = nbytes * (n - 1) / n
    d = out.setdefault(kind, {"count": 0, "bytes": 0.0, "wire": 0.0})
    d["count"] += count
    d["bytes"] += float(nbytes) * count
    d["wire"] += float(wire) * count


def collectives(cell: Cell, mesh) -> dict:
    """The collectives one device takes part in for a step of the cell:
    ``{kind: {count, bytes, wire}}``."""
    cfg, spec = cell.model.cfg, cell.shape
    sizes = mesh.shape
    out: dict = {}
    B = spec.global_batch
    ba = _batch_axes(mesh, B) or ()
    nb = math.prod(sizes[a] for a in ba)
    accum = cell.accum
    if spec.kind == "train":
        isz = _itemsize(flags.ring_sync_dtype())
        for s in _structs(cell.args[0]):
            shard = math.prod(shard_shape(s.shape, s.sharding))
            on = {a for p in s.sharding.spec for a in _axes(p)}
            n_rs = math.prod(sizes[a] for a in ba if a in on)
            n_ar = math.prod(sizes[a] for a in ba if a not in on)
            _add(out, "reduce-scatter", shard * n_rs * isz, n_rs)
            _add(out, "all-reduce", shard * isz, n_ar)
    ep = sizes.get("model", 1)
    if cfg.moe is not None and ep > 1 and cfg.family != "encdec":
        m, d = cfg.moe, cfg.d_model
        S = 1 if spec.kind == "decode" else spec.seq_len
        seq = S // ep if S % ep == 0 and S >= ep else S
        T = (B // nb) // accum * seq
        chunk = T if flags.ROOFLINE_MODE else min(DISPATCH_CHUNK, T)
        if T % chunk:
            chunk = T
        c_send = int(math.ceil(chunk * m.experts_per_token / ep *
                               m.capacity_factor))
        period = cell.model.period
        n_moe = sum(1 for i in range(cfg.num_layers)
                    if cfg.is_moe_layer(i % period))
        passes = 3 if spec.kind == "train" else 1   # + recompute, backward
        calls = n_moe * (T // chunk) * passes * accum
        act = _itemsize(getattr(torch, cfg.dtype))
        _add(out, "all-to-all", ep * c_send * d * act, ep, 2 * calls)
        _add(out, "all-to-all", ep * c_send * 8, ep, calls)   # int64 ids
    return out


def _terms(flops: float, nbytes: float, wire: float) -> dict:
    return {"t_compute": flops / PEAK_FLOPS, "t_memory": nbytes / HBM_BW,
            "t_collective": wire / LINK_BW}


def _full_params(cfg):
    from ..models.model import make_model
    from ..models.params import count_params
    from .steps import active_param_count
    n = count_params(make_model(cfg, device="meta").param_spec())
    return n, active_param_count(cfg, n)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             roofline: bool = False, mesh=None) -> dict:
    """One cell's record on the production mesh (``mesh`` overrides it)."""
    from ..models.model import make_model
    if mesh is None:
        mesh = make_production_mesh(
            multi_pod=multi_pod, devices=["meta"] * (512 if multi_pod
                                                     else 256))
    t0 = time.time()
    base = {"arch": arch, "shape": shape_name,
            "mesh": list(mesh.devices.shape), "chips": mesh.size,
            "device": "meta", "hardware": HARDWARE}
    if roofline:
        cfg = registry.get_config(arch)
        period = getattr(make_model(cfg, device="meta"), "period", 1)
        G = cfg.num_layers // period
        flags.set_roofline(True)
        try:
            ms, wires = [], []
            for depth in (period, 2 * period):
                cell = build_cell(arch, shape_name, mesh, depth_override=depth,
                                  policy_overrides={"scan_layers": False,
                                                    "accum": 1})
                ms.append(measure(cell))
                wires.append(sum(d["wire"] for d in
                                 collectives(cell, mesh).values()))
            colls = collectives(cell, mesh)
        finally:
            flags.set_roofline(False)
        (f1, f2), (b1, b2) = ([m[k] for m in ms] for k in
                              ("flops_per_device", "bytes_per_device"))

        def extrap(v1, v2):
            if v2 > v1 > 0:
                return v1 + (v2 - v1) * (G - 1)
            return v2 / 2.0 * G

        flops, nbytes, wire = extrap(f1, f2), extrap(b1, b2), \
            extrap(*wires)
        n, n_act = _full_params(cfg)
        return {**base, "run_s": round(time.time() - t0, 1),
                "flops_per_device": flops, "bytes_per_device": nbytes,
                "wire_bytes_per_device": wire, "collectives": colls,
                "collectives_not_ported": list(NOT_PORTED),
                "extrapolated": {"groups": G, "period": period,
                                 "g1": [f1, b1, wires[0]],
                                 "g2": [f2, b2, wires[1]]},
                "memory": {"note": "see the production record"},
                "model_params": n, "active_params": n_act,
                **_terms(flops, nbytes, wire), "ok": True}
    cell = build_cell(arch, shape_name, mesh)
    rec = measure(cell)
    colls = collectives(cell, mesh)
    wire = sum(d["wire"] for d in colls.values())
    return {**base, "run_s": round(time.time() - t0, 1), **rec,
            "collectives": colls, "wire_bytes_per_device": wire,
            "collectives_not_ported": list(NOT_PORTED),
            "model_params": cell.model_params,
            "active_params": cell.active_params,
            **_terms(rec["flops_per_device"], rec["bytes_per_device"], wire),
            "ok": True}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--roofline", action="store_true",
                    help="loop-free program at depths of 1 and 2 layer "
                         "groups, extrapolated (single-pod; stored under "
                         "key suffix /roofline)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.roofline:
        args.mesh = "single"

    out_path = Path(args.out)
    results = json.loads(out_path.read_text()) if out_path.exists() else {}

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = []
    for arch, spec, skip in registry.all_cells():
        if args.arch and registry.canonical(args.arch) != arch:
            continue
        if args.shape and spec.name != args.shape:
            continue
        cells.append((arch, spec, skip))

    for arch, spec, skip in cells:
        for mp in meshes:
            mesh_name = "roofline" if args.roofline else \
                ("multi" if mp else "single")
            key = f"{arch}/{spec.name}/{mesh_name}"
            if skip:
                results[key] = {"arch": arch, "shape": spec.name,
                                "skipped": skip, "ok": True}
                out_path.write_text(json.dumps(results, indent=1))
                print(f"[skip] {key}: {skip}")
                continue
            if key in results and results[key].get("ok") and not args.force:
                print(f"[cached] {key}")
                continue
            print(f"[run] {key} ...", flush=True)
            try:
                res = run_cell(arch, spec.name, mp, roofline=args.roofline)
                mem = res["memory"].get("per_device_total")
                print(f"  ok: {res['run_s']}s "
                      + (f"mem/dev={mem / 2**30:.2f}GiB " if mem else "")
                      + f"t_comp={res['t_compute'] * 1e3:.2f}ms "
                      f"t_mem={res['t_memory'] * 1e3:.2f}ms "
                      f"t_coll={res['t_collective'] * 1e3:.2f}ms",
                      flush=True)
            except Exception as e:  # noqa: BLE001 - record and continue
                res = {"arch": arch, "shape": spec.name, "ok": False,
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                print(f"  FAIL: {res['error'][:200]}", flush=True)
            results[key] = res
            out_path.write_text(json.dumps(results, indent=1))
    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells ok -> {out_path}")


if __name__ == "__main__":
    main()
