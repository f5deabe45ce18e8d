"""Multi-pod dry-run over meta tensors: every (architecture x input shape)
cell on the production meshes, sized and counted without a device.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell with XLA and reads its memory and cost analyses; the port runs
one rank's share of the cell's ``fn`` once on the meta device (shapes and
dtypes, no values, no allocation) and counts what it does:

* **Meshes** are the production meshes over meta devices
  (``make_production_mesh(multi_pod=..., devices=["meta"] * n)``).
* **A rank's share** (:func:`rank_share`).  A *partitioned* cell (the
  dense GQA and MLA, MoE, SSM and hybrid families' ``train`` and
  ``prefill`` cells on a ``model`` axis larger than 1,
  ``Cell.partitioned``) runs one rank's partitioned program: every
  argument is cut to the rank's block by its sharding (the optimizer state as its parameter is: the ZeRO-1
  sharding over ``pod`` of the multi-pod mesh is not partitioned, and the
  record says so), and the run is alone in :func:`~repro_torch.parallel.spmd.lone_rank` mode,
  whose collectives keep their shapes and are recorded.  Every other cell
  splits the batch axes of the inputs and the decode cache over ``(pod,
  data)`` as ``batch_axes`` places them and runs at full model width
  (GSPMD's partitioning of decode and of the VLM and encoder-decoder
  families is ROADMAP queue 1 item 1, left 6; such a
  run's MoE layers dispatch on one device): ``memory.temp`` is then
  measured at that width, the record says so
  (``temp_at_full_model_width``), and ``flops_per_device`` and
  ``bytes_per_device`` are the counts divided by the ``model`` axis size;
  a partitioned record's are the rank's own.
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
* ``collectives`` and ``wire_bytes_per_device``: by the reference's
  per-kind ring formulas (``dryrun.py:79-86``).  A partitioned record's
  are the collectives its rank's run recorded (``spmd.TALLY``): the
  tensor-parallel all-gathers, reduce-scatters and all-reduces over
  ``model`` with their backward transposes, FSDP's parameter all-gathers
  over ``data`` (again in the recompute) and their gradients'
  reduce-scatters, the MoE's ``all_to_all``s over ``model`` (tokens out,
  their expert ids, results back; the two token exchanges' transposes in
  the backward; none in the recompute, which is rank-local) and its
  router's all-gathers, the gradient sums and the loss's and aux loss's;
  ``collectives_by_axes`` splits them by axes.  Otherwise from the shardings: a train cell's
  gradient sync over its batch axes in ``flags.RING_SYNC_DTYPE`` (an
  all-reduce, or a reduce-scatter over the axes a leaf is already sharded
  on), and each MoE dispatch's ``all_to_all``s over ``model``
  (``moe_rank``: tokens out, their expert ids, results back; in
  training also in the recompute and the backward); the collectives that
  only GSPMD's tensor parallelism would add are left out and named in
  ``collectives_not_ported``.
* The roofline terms use the card's spec-sheet numbers (:data:`HARDWARE`):
  ``t_compute`` = flops / 989e12, ``t_memory`` = bytes / 3.35e12,
  ``t_collective`` = wire bytes / 450e9 (NVLink 4's 900 GB/s a GPU, both
  directions, halved: one direction), and ``memory.fits_h100`` holds the
  total against the card's own memory, :data:`HBM_BYTES` (what
  ``torch.cuda.get_device_properties(0).total_memory`` reports: 79.18
  GiB, not the spec sheet's 80).

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
from ..parallel import spmd
from ..parallel.sharding import batch_axes, local_shape, part_axes
from .mesh import make_production_mesh
from .steps import Cell, build_cell, materialize

__all__ = ["HARDWARE", "PEAK_FLOPS", "HBM_BW", "LINK_BW", "HBM_BYTES",
           "HBM_SPEC_BYTES", "HBM_CARD", "fits_h100", "by_axes",
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
# the card's own memory, as torch.cuda.get_device_properties(0).total_memory
# reports it on an NVIDIA H100 80GB HBM3 at a 700 W power limit
HBM_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
HBM_BYTES = 85_017_493_504          # 79.18 GiB
HBM_SPEC_BYTES = 80 * 1024**3       # the spec sheet's "80 GB" (not used)
ALLOC_BYTES = 512            # the CUDA caching allocator's rounding
BATCH_AXES = frozenset(("pod", "data"))
NOT_PORTED = ("tensor-parallel all-reduces and all-gathers over 'model' "
              "(GSPMD's partitioning of decode cells and of the VLM and "
              "encoder-decoder families: ROADMAP queue 1 item 1, left 6)",
              "FSDP parameter all-gathers over 'data' (GSPMD, left 6)")
ZERO1_POD = ("ZeRO-1 of the optimizer state over 'pod' (the partitioned "
             "program holds it as its parameter: ROADMAP queue 1 item 1, "
             "left 6)")


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _structs(tree) -> list[ShapeDtypeStruct]:
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, ShapeDtypeStruct)]


def _block(s: ShapeDtypeStruct, sharding=None) -> ShapeDtypeStruct:
    """The rank's block of ``s`` under ``sharding`` (default its own)."""
    sh = sharding or s.sharding
    if sh is None:
        return ShapeDtypeStruct(s.shape, s.dtype)
    return ShapeDtypeStruct(local_shape(s.shape, sh.spec, sh.mesh), s.dtype)


def rank_share(cell: Cell) -> tuple:
    """The cell's abstract args as one rank holds them in the program the
    port runs.  Partitioned cells: every argument's block by its sharding,
    the optimizer state's by its parameter's.  Others: in the batch
    arguments (inputs, labels, decode cache) each dimension sharded over
    batch axes only ("pod", "data") is divided by their size; every other
    dimension is whole (the ``model`` axis is not partitioned)."""
    if cell.partitioned:
        params = cell.args[0]
        out = [pytree.tree_map(_block, params)]
        if cell.shape.kind == "train":
            opt = cell.args[1]
            like = [pytree.tree_map(lambda s, p: _block(s, p.sharding), t,
                                    params) if t is not None else None
                    for t in (opt.m, opt.v, opt.master)]
            out.append(opt._replace(step=_block(opt.step), m=like[0],
                                    v=like[1], master=like[2]))
        out.append(pytree.tree_map(_block, cell.args[-1]))
        return tuple(out)

    def share(s):
        if not isinstance(s, ShapeDtypeStruct) or s.sharding is None:
            return s
        sizes = s.sharding.mesh.shape
        shape = list(s.shape)
        for i, part in enumerate(s.sharding.spec):
            axes = part_axes(part)
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
    accessed, the memory record and, for a partitioned cell, the
    collectives its rank recorded (see the module docstring)."""
    mesh = cell.model.mesh
    mesh_tp = cell.model.tp
    share = rank_share(cell)
    args = materialize(cell, share, "meta")
    track = LiveBytes()
    held = sum(track.hold(t) for t in pytree.tree_leaves(args)
               if isinstance(t, torch.Tensor))
    # what a device holds of the args: a partitioned rank its blocks, any
    # other the shardings' shards (its share may hold more of them)
    held_args = share if cell.partitioned else cell.args
    donated = {}
    for i in cell.donate:
        for s, t in zip(_structs(held_args[i]), pytree.tree_leaves(args[i])):
            donated[t.untyped_storage()._cdata] = shard_bytes(s)
    rank = spmd.lone_rank(mesh) if cell.partitioned else \
        _one_rank(cell.model)
    t0 = time.time()
    spmd.TALLY.clear()
    with rank, FlopCounterMode(display=False) as fc, track:
        out = cell.fn(*args)
    secs = time.time() - t0
    recorded = {k: (c, spmd.TALLY.bytes[k])
                for k, c in spmd.TALLY.count.items()}
    spmd.TALLY.clear()
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
    argument = sum(shard_bytes(s) for s in _structs(held_args))
    mem = {"argument": argument, "output": alias + new, "alias": alias,
           "temp": track.peak - held - new_held}
    mem["per_device_total"] = memory_total(mem)
    mem["fits_h100"] = fits_h100(mem["per_device_total"])
    mem["temp_at_full_model_width"] = mesh_tp > 1 and not cell.partitioned
    div = 1 if cell.partitioned else mesh_tp
    rec = {"flops_per_device": fc.get_total_flops() / div,
           "bytes_per_device": track.accessed / div,
           "memory": mem, "meta_run_s": secs}
    if cell.partitioned:
        rec["recorded"] = recorded
    return rec


def fits_h100(total: int) -> bool:
    """Whether ``total`` bytes a device fit the card's own memory."""
    return bool(total <= HBM_BYTES)


def _add(out: dict, kind: str, nbytes: float, n: int, count: int = 1):
    """One collective of ``nbytes`` operand bytes a device over a group of
    ``n``, ``count`` times, with the reference's ring wire bytes."""
    if n <= 1:
        return
    wire = _wire(kind, nbytes, n)
    d = out.setdefault(kind, {"count": 0, "bytes": 0.0, "wire": 0.0})
    d["count"] += count
    d["bytes"] += float(nbytes) * count
    d["wire"] += float(wire) * count


def _wire(kind: str, nbytes: float, n: int) -> float:
    if kind == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    return nbytes * (n - 1) / n


def collectives(cell: Cell, mesh, recorded: dict | None = None) -> dict:
    """The collectives one device takes part in for a step of the cell:
    ``{kind: {count, bytes, wire}}``; for a partitioned cell those its
    rank ``recorded`` (:func:`measure`'s ``{(kind, axes, n): (count,
    bytes)}``)."""
    if cell.partitioned:
        out: dict = {}
        for (kind, _, n), (c, b) in sorted(recorded.items()):
            d = out.setdefault(kind, {"count": 0, "bytes": 0.0, "wire": 0.0})
            d["count"] += c
            d["bytes"] += float(b)
            d["wire"] += float(_wire(kind, b, n))
        return out
    cfg, spec = cell.model.cfg, cell.shape
    sizes = mesh.shape
    out: dict = {}
    B = spec.global_batch
    ba = batch_axes(mesh, B) or ()
    nb = math.prod(sizes[a] for a in ba)
    accum = cell.accum
    if spec.kind == "train":
        isz = _itemsize(flags.ring_sync_dtype())
        for s in _structs(cell.args[0]):
            shard = math.prod(shard_shape(s.shape, s.sharding))
            on = {a for p in s.sharding.spec for a in part_axes(p)}
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


def by_axes(recorded: dict) -> dict:
    """``{"<kind> over <axes>": count}`` of a rank's recorded collectives."""
    out: dict = {}
    for (kind, axes, _), (c, _) in sorted(recorded.items()):
        k = f"{kind} over {','.join(axes)}"
        out[k] = out.get(k, 0) + c
    return out


def _not_ported(cell: Cell, mesh) -> list[str]:
    if not cell.partitioned:
        return list(NOT_PORTED)
    return [ZERO1_POD] if "pod" in mesh.shape and \
        cell.shape.kind == "train" else []


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
                colls = collectives(cell, mesh, ms[-1].get("recorded"))
                wires.append(sum(d["wire"] for d in colls.values()))
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
                "collectives_not_ported": _not_ported(cell, mesh),
                "extrapolated": {"groups": G, "period": period,
                                 "g1": [f1, b1, wires[0]],
                                 "g2": [f2, b2, wires[1]]},
                "memory": {"note": "see the production record"},
                "model_params": n, "active_params": n_act,
                **_terms(flops, nbytes, wire), "ok": True}
    cell = build_cell(arch, shape_name, mesh)
    rec = measure(cell)
    recorded = rec.pop("recorded", None)
    colls = collectives(cell, mesh, recorded)
    wire = sum(d["wire"] for d in colls.values())
    if recorded is not None:
        rec["collectives_by_axes"] = by_axes(recorded)
    return {**base, "run_s": round(time.time() - t0, 1), **rec,
            "partitioned": cell.partitioned,
            "collectives": colls, "wire_bytes_per_device": wire,
            "collectives_not_ported": _not_ported(cell, mesh),
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
