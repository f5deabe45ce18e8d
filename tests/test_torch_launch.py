"""The port's launch layer against the JAX package.

- **Cell structure.**  For every cell of ``registry.all_cells()`` on both
  production meshes, ``build_cell`` over meta devices gives what the
  reference's gives on 256 / 512 host devices (a child python with
  ``--xla_force_host_platform_device_count=512``): the same parameter
  counts, skip reasons and ``donate``, and per leaf of ``args`` the same
  shape, dtype and ``PartitionSpec``.  The reference stacks a layer axis
  (``block_<i>`` ``[n_groups, ...]``, ``encoder``/``decoder`` ``[L, ...]``,
  the caches' leading axis), unsharded; the port keeps one leaf a layer,
  so each stacked leaf is compared with the port's leaves of its layers,
  less that axis.
- **Bytes.**  The dry-run's ``memory.argument`` equals XLA's
  ``argument_size_in_bytes`` exactly at ``depth_override=1`` on a (data 2,
  model 4) mesh (8 host devices), for a decode (danube), a prefill (the MoE
  granite) and a train cell (the SSM mamba2; the last two partitioned).
  Output and alias bytes differ where XLA chose an output sharding the
  port's record does not assume; each such leaf is named and the difference pinned: XLA shards
  the logits over ``model``, returns mamba2's ``ssm/conv_BC``, ``wB`` and
  ``wC`` (and their m, v, master) sharded over ``model`` where they came
  in replicated (so not aliased), aliases the optimizer step (the port's
  ``adamw_update`` returns a new one), and counts a table of 8 bytes per
  output of a tuple.  mamba2's decode cell: jit prunes the unused ``pos``
  argument (256 bytes) and returns the conv window sharded over ``model``.
- **Flops.**  ``flops_per_device`` of danube's ``prefill_32k`` and
  ``train_4k`` at depths 1 and 2 under ``ROOFLINE_MODE`` on a one-device
  mesh against the reference's ``--roofline`` cost-analysis flops: XLA
  also counts elementwise operations, ``FlopCounterMode`` only products;
  measured 0.990-0.997 of XLA's, held to 0.98-1.0.
- **Cell values.**  One step of the port's ``_train_cell`` (accum 1 and
  2), ``_prefill_cell`` and ``_decode_cell`` fns against the reference's
  private builders of the same names on the SMOKE configs of a dense, an
  SSM and an MoE family, in float32 (weights carried over by
  ``models/convert.py``): the tolerances of ``tests/test_torch_train.py``
  (losses rtol 1e-5, parameters atol 5e-5 / rtol 1e-4; lr 1e-3 at step 1,
  where AdamW moves each weight by about lr times the sign of its
  gradient, so a gradient within rounding of 0 may move a weight by up to
  lr on one side and less on the other: at lr 1e-2 one of danube's
  65,536 ``mlp/wi`` entries parted by 1.4e-4) and
  ``tests/test_torch_models.py`` (logits rtol 1e-4 / atol 1e-3; decode,
  which reads a bf16 cache, atol 1e-2).
- **Flags.**  ``ssd_reference_vec`` against the reference's on its
  ``SSD_CASES`` shapes (numpy inputs) in float32 at the reference's 5e-4
  and under ``SSD_BF16`` at 2e-2 (bf16 products); the roofline routes of
  cross-entropy, attention and the MoE dispatch equal the production
  routes; ``set_ring_sync_dtype``.
- **Restore** onto a CPU mesh from an abstract tree, bit for bit; the
  dry-run's command line.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as RMesh  # noqa: E402
from repro import flags as r_flags  # noqa: E402
from repro.config import ShapeSpec as RShapeSpec  # noqa: E402
from repro.config import TrainConfig as RTrainConfig  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.launch import steps as r_steps  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.models.params import cast_tree as r_cast_tree  # noqa: E402
from repro.models.ssm import ssd_reference_vec as r_ssd_vec  # noqa: E402
from repro.optim.adamw import OptState as ROptState  # noqa: E402
from repro.parallel.sharding import make_rules as r_make_rules  # noqa: E402

from repro_torch import flags  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.config import ShapeSpec, TrainConfig  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as P_steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402,E501
from repro_torch.models import attention as P_attention  # noqa: E402
from repro_torch.models import moe as P_moe  # noqa: E402
from repro_torch.models.convert import (_reference_leaf,  # noqa: E402
                                        params_from_reference)
from repro_torch.models.model import make_model  # noqa: E402
from repro_torch.models.params import (ShapeDtypeStruct,  # noqa: E402
                                       cast_tree, param_at, shard_bytes,
                                       tree_leaves_with_path, unflatten)
from repro_torch.models.ssm import ssd_reference_vec  # noqa: E402
from repro_torch.optim.adamw import OptState  # noqa: E402
from repro_torch.parallel.sharding import NamedSharding, make_rules  # noqa: E402,E501
from repro_torch.parallel.spmd import P  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s.name, skip) for a, s, skip in registry.all_cells()]
BYTES_CELLS = [("h2o_danube_3_4b", "decode_32k"),
               ("granite_moe_1b_a400m", "prefill_32k"),
               ("mamba2_130m", "train_4k"), ("mamba2_130m", "decode_32k")]
FLOPS_BAND = (0.98, 1.0)
FAMILIES = ["h2o_danube_3_4b", "mamba2_130m", "granite_moe_1b_a400m"]
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-3)
DECODE_TOL = dict(rtol=1e-4, atol=1e-2)
B, S = 4, 32                # the cell-value tests' ShapeSpec
SSD_CASES = [(2, 256, 3, 32, 16, 64), (1, 128, 2, 64, 32, 32),
             (2, 200, 2, 32, 16, 64), (2, 256, 4, 64, 16, 128)]
SSD_TOL = {False: 5e-4, True: 2e-2}


def _child(script: str, devices: int) -> dict:
    """Run ``script`` (which prints one JSON line last) in a python with
    ``devices`` host devices."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


_REF_CELLS = r"""
import json
import numpy as np, jax
from jax.sharding import Mesh
from repro.configs import registry
from repro.launch.steps import build_cell

def parts(sh):
    out = [[] if p is None else ([p] if isinstance(p, str) else list(p))
           for p in sh.spec]
    while out and not out[-1]:
        out.pop()
    return out

def key(k):
    for a in ("key", "name", "idx"):
        if hasattr(k, a):
            return str(getattr(k, a))

devs = np.array(jax.devices())
out = {}
with jax.threefry_partitionable(False):
    for mp in (False, True):
        mesh = Mesh(devs.reshape(2, 16, 16), ("pod", "data", "model")) if mp \
            else Mesh(devs[:256].reshape(16, 16), ("data", "model"))
        for arch, spec, skip in registry.all_cells():
            k = f"{arch}/{spec.name}/{'multi' if mp else 'single'}"
            if skip:
                out[k] = {"skip": skip}
                continue
            c = build_cell(arch, spec.name, mesh)
            out[k] = {"donate": list(c.donate),
                      "counts": [c.model_params, c.active_params],
                      "args": [[["/".join(key(x) for x in p), list(v.shape),
                                 str(v.dtype), None if v.sharding is None
                                 else parts(v.sharding)]
                                for p, v in
                                jax.tree_util.tree_flatten_with_path(a)[0]]
                               for a in c.args]}
print(json.dumps(out))
"""

_REF_MEMORY = r"""
import json, math
import numpy as np, jax
from jax.sharding import Mesh
from repro import flags
from repro.launch.dryrun import _cost_dict, _measure
from repro.launch.steps import build_cell

CELLS = %r
# (importing the reference's dryrun asks for 512 host devices)
devs = np.array(jax.devices())
mesh = Mesh(devs[:8].reshape(2, 4), ("data", "model"))
out = {}
with jax.threefry_partitionable(False):
    for arch, shape in CELLS:
        c = build_cell(arch, shape, mesh, depth_override=1)
        with mesh:
            m = jax.jit(c.fn, donate_argnums=c.donate).lower(
                *c.args).compile().memory_analysis()
        out[f"{arch}/{shape}"] = [m.argument_size_in_bytes,
                                  m.output_size_in_bytes,
                                  m.alias_size_in_bytes]
    one = Mesh(devs[:1].reshape(1, 1), ("data", "model"))
    flags.set_roofline(True)
    for shape in ("prefill_32k", "train_4k"):
        for d in (1, 2):
            _, comp = _measure("h2o_danube_3_4b", shape, one,
                               {"scan_layers": False, "accum": 1}, d)
            out[f"flops/{shape}/{d}"] = float(
                _cost_dict(comp.cost_analysis()).get("flops", 0.0))
print(json.dumps(out))
""" % (BYTES_CELLS,)


@pytest.fixture(scope="module")
def ref_cells():
    return _child(_REF_CELLS, 512)


@pytest.fixture(scope="module")
def ref_memory():
    return _child(_REF_MEMORY, 8)


@pytest.fixture(scope="module")
def meta_meshes():
    return {mp: make_production_mesh(multi_pod=mp,
                                     devices=["meta"] * (512 if mp else 256))
            for mp in (False, True)}


# ------------------------------------------------------------ structure


def _parts(sh):
    out = [list(P_axes(p)) for p in sh.spec]
    while out and not out[-1]:
        out.pop()
    return out


def P_axes(part):
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _flat(getattr(tree, k), prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _port_leaves(arg) -> dict:
    return {"/".join(p): (list(x.shape), str(x.dtype).removeprefix("torch."),
                          None if x.sharding is None else _parts(x.sharding))
            for p, x in _flat(arg)}


def _unstacked(path, shape, dtype, spec, period, argnum, kind) -> dict:
    """The reference's leaf as the port's per-layer leaves: a stacked leaf
    (``block_<i>`` ``[G, ...]``, ``encoder``/``decoder`` and the caches'
    ``[L, ...]``) gives layer ``g * period + i`` (or ``l``) its slice."""
    p = path.split("/")
    if kind == "decode" and argnum == 1:           # the cache
        if p[0].startswith("block_"):
            i = int(p[0][6:])
            keys = [[str(g * period + i)] + p[1:] for g in range(shape[0])]
        else:                                      # self_kv/k, cross_k
            keys = [[p[0], str(l)] + p[1:] for l in range(shape[0])]
    else:
        # parameters (argnum 0), or the optimizer's m/v/master (train's 1)
        head = p[:1] if (kind == "train" and argnum == 1) else []
        q = p[len(head):]
        stacked = (argnum == 0 or head) and q and (
            q[0].startswith("block_") or q[0] in ("encoder", "decoder"))
        if not stacked:
            return {path: (shape, dtype, spec)}
        if q[0].startswith("block_"):
            i = int(q[0][6:])
            keys = [head + ["blocks", str(g * period + i)] + q[1:]
                    for g in range(shape[0])]
        else:
            keys = [head + [q[0], str(l)] + q[1:] for l in range(shape[0])]
    assert not (spec and spec[0]), (path, spec)    # the layer axis is whole
    return {"/".join(k): (shape[1:], dtype, spec[1:] if spec else spec)
            for k in keys}


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch,shape,skip", CELLS,
                         ids=[f"{a}/{s}" for a, s, _ in CELLS])
def test_cell_structure_matches_reference(ref_cells, meta_meshes, arch,
                                          shape, skip, multi):
    ref = ref_cells[f"{arch}/{shape}/{'multi' if multi else 'single'}"]
    if skip:
        assert ref == {"skip": skip}
        return
    cell = P_steps.build_cell(arch, shape, meta_meshes[multi])
    assert [cell.model_params, cell.active_params] == ref["counts"]
    assert list(cell.donate) == ref["donate"]
    assert len(cell.args) == len(ref["args"])
    period = getattr(cell.model, "period", 1)
    for i, (arg, rarg) in enumerate(zip(cell.args, ref["args"])):
        want = {}
        for path, shp, dt, spec in rarg:
            want.update(_unstacked(path, shp, dt, spec, period, i,
                                   cell.shape.kind))
        got = _port_leaves(arg)
        assert got.keys() == want.keys(), (i, sorted(got.keys() ^
                                                     want.keys())[:6])
        bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        assert not bad, (i, list(bad.items())[:4])


# ------------------------------------------------------------ bytes


def _leaf(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) and \
            not hasattr(tree, "_fields") else (
                getattr(tree, k) if hasattr(tree, "_fields") else tree[k])
    return tree


def _xla_side(cell, rec):
    """What XLA reports for the cell, from the port's record and the leaves
    whose outputs XLA places otherwise (module docstring): (argument,
    output, alias)."""
    mem = rec["memory"]
    arg, out, alias = mem["argument"], mem["output"], mem["alias"]
    kind = cell.shape.kind
    tp = cell.model.mesh.shape["model"]
    if kind == "train":
        # mamba2's B/C projections and conv weights (and their m, v and
        # master) come back sharded over model: not aliased.  XLA's
        # placement, so the same for the port's partitioned record (its
        # outputs are its blocks of the donated args, as at full width)
        for tree in (cell.args[0], cell.args[1].m, cell.args[1].v,
                     cell.args[1].master):
            for p, s in _flat(tree):
                if p[-2:-1] == ("ssm",) and p[-1] in ("conv_BC", "wB",
                                                      "wC"):
                    alias -= shard_bytes(s)
                    out -= shard_bytes(s) - shard_bytes(s) // tp
        alias += 4                  # XLA aliases the step; the port not
        n_out = len(list(_flat(cell.args[0]))) + \
            len(list(_flat(cell.args[1]))) + 3      # + loss, lr, grad_norm
        out += 8 * n_out            # the output tuple's table
    elif kind == "prefill":
        if not cell.partitioned:    # a partitioned rank's is its block
            out -= out - out // tp  # logits[:, -1] sharded over model
    else:
        logits = cell.shape.global_batch // 2 * cell.model.vocab_padded * 2
        out -= logits - logits // tp        # logits sharded over model
        if cell.model.cfg.family == "ssm":
            arg -= cell.shape.global_batch // 2 * 4     # pos: pruned
            for c in cell.args[1]:                      # conv over model
                alias -= shard_bytes(c.conv)
                out -= shard_bytes(c.conv) - shard_bytes(c.conv) // tp
        out += 8 * 2                # (logits, cache) table ...
        out += 8 * (len(list(_flat(cell.args[1]))) - 1)  # ... of leaves
    return arg, out, alias


@pytest.mark.parametrize("arch,shape", BYTES_CELLS,
                         ids=[f"{a}/{s}" for a, s in BYTES_CELLS])
def test_argument_output_alias_bytes_against_xla(ref_memory, arch, shape):
    mesh = make_mesh((2, 4), ("data", "model"), ["meta"] * 8)
    cell = P_steps.build_cell(arch, shape, mesh, depth_override=1)
    rec = dryrun.measure(cell)
    want = ref_memory[f"{arch}/{shape}"]
    if (arch, shape) != ("mamba2_130m", "decode_32k"):
        # every argument is used: the argument bytes are XLA's exactly
        assert rec["memory"]["argument"] == want[0]
    assert list(_xla_side(cell, rec)) == want, (rec["memory"], want)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_flops_against_xla_roofline(ref_memory, shape, depth):
    one = make_mesh((1, 1), ("data", "model"), ["meta"])
    flags.set_roofline(True)
    try:
        cell = P_steps.build_cell("h2o_danube_3_4b", shape, one,
                                  depth_override=depth,
                                  policy_overrides={"scan_layers": False,
                                                    "accum": 1})
        got = dryrun.measure(cell)["flops_per_device"]
    finally:
        flags.set_roofline(False)
    ratio = got / ref_memory[f"flops/{shape}/{depth}"]
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio


def test_dryrun_record_on_a_sharded_mesh(meta_meshes):
    """A production record: H100 constants, the model axis divided out of
    the counts and named in the record, the total its parts."""
    rec = dryrun.run_cell("mamba2_130m", "decode_32k", multi_pod=True)
    mem = rec["memory"]
    assert rec["hardware"].startswith("NVIDIA H100") and rec["ok"]
    assert mem["temp_at_full_model_width"] and "fits_h100" in mem
    assert mem["per_device_total"] == dryrun.memory_total(mem) > 0
    assert rec["t_compute"] == rec["flops_per_device"] / 989e12
    assert rec["t_memory"] == rec["bytes_per_device"] / 3.35e12
    assert "all-to-all" not in rec["collectives"]     # no MoE
    assert "fits_v5e" not in mem and rec["collectives_not_ported"]


def test_collectives_of_a_moe_train_cell(meta_meshes):
    """granite's train_4k on (data 16, model 16): a gradient all-reduce a
    parameter over data in float32, and per MoE layer and microbatch three
    passes of two token all_to_alls and one id all_to_all."""
    mesh = meta_meshes[False]
    cell = P_steps.build_cell("granite_moe_1b_a400m", "train_4k", mesh)
    # the cell is partitioned (its record's collectives are its rank's,
    # tests/test_torch_tp_moe.py); the formulas here are those of a MoE
    # cell at full model width (the MoE decode cells; jamba's train and
    # prefill cells are partitioned too, tests/test_torch_tp_ssm.py)
    assert cell.partitioned
    cell = dataclasses.replace(cell, partitioned=False)
    c = dryrun.collectives(cell, mesh)
    n_leaves = len(list(_flat(cell.args[0])))
    assert c["all-reduce"]["count"] == n_leaves
    grad_bytes = sum(math.prod(s.shape) * 4 // (
        16 if s.sharding.spec and any(p for p in s.sharding.spec) else 1)
        for _, s in _flat(cell.args[0]))
    assert c["all-reduce"]["bytes"] <= grad_bytes
    accum = cell.accum
    assert c["all-to-all"]["count"] == 24 * 3 * 3 * accum
    flags.set_ring_sync_dtype("bfloat16")
    try:
        half = dryrun.collectives(cell, mesh)["all-reduce"]["bytes"]
    finally:
        flags.set_ring_sync_dtype("float32")
    assert half * 2 == c["all-reduce"]["bytes"]


def test_production_mesh_without_devices_needs_the_cards():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="256 CUDA devices"):
        make_production_mesh()


def test_dryrun_main_writes_its_own_records(tmp_path, capsys):
    out = tmp_path / "records.json"
    dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                 "--out", str(out)])
    dryrun.main(["--arch", "qwen2-vl-2b", "--shape", "long_500k",
                 "--mesh", "single", "--out", str(out)])
    dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(out)])
    assert "[cached] mamba2_130m/decode_32k/single" in capsys.readouterr().out
    rec = json.loads(out.read_text())
    assert set(rec) == {"mamba2_130m/decode_32k/single",
                        "mamba2_130m/decode_32k/multi",
                        "qwen2_vl_2b/long_500k/single"}
    assert all(r["ok"] for r in rec.values()), rec
    assert rec["qwen2_vl_2b/long_500k/single"]["skipped"]
    multi = rec["mamba2_130m/decode_32k/multi"]
    assert multi["chips"] == 512 and multi["mesh"] == [2, 16, 16]
    assert multi["memory"]["fits_h100"] is True
    assert dryrun.DEFAULT_OUT.name == "dryrun_results_torch.json"
    assert "dryrun_results_torch.json" in (ROOT / ".gitignore").read_text()


# ------------------------------------------------------------ cell values


def _np(x):
    return np.asarray(x, np.float32)


def _pair(arch, kind, seq=S, accum=1):
    """The reference's and the port's private cell builders on the SMOKE
    config in float32 over a one-device mesh, and the reference's weights
    as the port's parameter tree."""
    pcfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                               dtype="float32")
    rcfg = dataclasses.replace(r_registry.get_config(arch, smoke=True),
                               dtype="float32")
    pol = dict(P_steps.ARCH_POLICY[arch], accum=accum)
    par = P_steps.make_parallel_config(arch, "tiny")
    rpar = r_steps.make_parallel_config(arch, "tiny")
    rmesh = RMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
    pmesh = make_mesh((1, 1), ("data", "model"), ["cpu"])
    rrules = r_make_rules(fsdp=par.fsdp)
    prules = make_rules(fsdp=par.fsdp)
    rmodel = r_build_model(rcfg, rpar, mesh=rmesh, rules=rrules)
    with jax.threefry_partitionable(False):
        rparams = r_cast_tree(rmodel.init(jax.random.PRNGKey(0)),
                              jnp.float32)
    pmodel = make_model(pcfg, par, device="meta", mesh=pmesh, rules=prules)
    held = params_from_reference(
        pcfg, jax.tree.map(_np, rparams), "cpu", par=par, mesh=pmesh,
        rules=prules)
    cast_tree(held, torch.float32)
    ptree = unflatten({
        path: param_at(held, path).detach().clone()
        for path, _ in tree_leaves_with_path(pmodel.param_spec())})
    ctx = dict(arch=arch, pcfg=pcfg, rcfg=rcfg, pol=pol, par=par, rpar=rpar,
               rmesh=rmesh, pmesh=pmesh, rrules=rrules, prules=prules,
               rmodel=rmodel, pmodel=pmodel, rparams=rparams, ptree=ptree,
               pspec=ShapeSpec("tiny", kind, seq, B),
               rspec=RShapeSpec("tiny", kind, seq, B))
    return ctx


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _params_close(ctx, got_tree, want_tree):
    for path, _ in tree_leaves_with_path(ctx["pmodel"].param_spec()):
        got = _np(P_steps._leaf(got_tree, path).detach())
        want = _reference_leaf(jax.tree.map(_np, want_tree), path,
                               ctx["pmodel"])
        np.testing.assert_allclose(got, want, err_msg="/".join(path),
                                   **PARAM_TOL)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_cell_step_matches_reference(arch, accum):
    ctx = _pair(arch, "train", accum=accum)
    kw = dict(global_batch=B, seq_len=S, lr=1e-3, warmup_steps=1,
              total_steps=10, opt_state_dtype="float32", master_weights=True)
    pcell = P_steps._train_cell(arch, ctx["pcfg"], ctx["pspec"],
                                TrainConfig(**kw), ctx["par"], ctx["pmodel"],
                                ctx["pmesh"], ctx["prules"], 0, 0, ctx["pol"])
    rcell = r_steps._train_cell(arch, ctx["rcfg"], ctx["rspec"],
                                RTrainConfig(**kw), ctx["rpar"],
                                ctx["rmodel"], ctx["rmesh"], ctx["rrules"],
                                0, 0, ctx["pol"])
    assert pcell.accum == accum
    toks = _tokens(ctx["pcfg"], (B, S + 1), 1)
    # step 1: the warm-up's lr is 1e-2 there (0 at step 0)
    rzero = jax.tree.map(jnp.zeros_like, ctx["rparams"])
    ropt = ROptState(step=jnp.int32(1), m=rzero, v=rzero,
                     master=ctx["rparams"])
    rp, _, rm = jax.jit(rcell.fn)(ctx["rparams"], ropt, {
        "tokens": jnp.asarray(toks[:, :-1]),
        "labels": jnp.asarray(toks[:, 1:])})
    ptree = ctx["ptree"]

    def like(t, fn):
        return {k: like(v, fn) if isinstance(v, dict) else fn(v)
                for k, v in t.items()}
    popt = OptState(torch.tensor(1, dtype=torch.int32),
                    like(ptree, torch.zeros_like),
                    like(ptree, torch.zeros_like),
                    like(ptree, torch.clone))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    pp, po, pm = pcell.fn(ptree, popt, batch)
    # donation: the parameters and optimizer state were updated in place
    assert pp is ptree and po.m is popt.m and int(po.step) == 2
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-4)
    _params_close(ctx, pp, rp)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_cell_matches_reference(arch):
    ctx = _pair(arch, "prefill")
    pcell = P_steps._prefill_cell(arch, ctx["pcfg"], ctx["pspec"],
                                  ctx["pmodel"], ctx["pmesh"],
                                  ctx["prules"], 0, 0)
    rcell = r_steps._prefill_cell(arch, ctx["rcfg"], ctx["rspec"],
                                  ctx["rmodel"], ctx["rmesh"],
                                  ctx["rrules"], 0, 0)
    toks = _tokens(ctx["pcfg"], (B, S), 2)
    want = jax.jit(rcell.fn)(ctx["rparams"], {"tokens": jnp.asarray(toks)})
    got = pcell.fn(ctx["ptree"], {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, ctx["pmodel"].vocab_padded)
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_cell_matches_reference(arch):
    ctx = _pair(arch, "decode", seq=16)
    pcell = P_steps._decode_cell(arch, ctx["pcfg"], ctx["pspec"],
                                 ctx["pmodel"], ctx["pmesh"],
                                 ctx["prules"], 0, 0)
    rcell = r_steps._decode_cell(arch, ctx["rcfg"], ctx["rspec"],
                                 ctx["rmodel"], ctx["rmesh"],
                                 ctx["rrules"], 0, 0)
    rng = np.random.default_rng(3)
    rcache, period = {}, ctx["pmodel"].period
    for name, c in rcell.args[1].items():       # random stacked caches
        rcache[name] = type(c)(*(jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32) * 0.5, x.dtype)
            for x in c))
    pcache = []
    for l, c in enumerate(pcell.args[1]):
        rc = rcache[f"block_{l % period}"]
        pcache.append(type(c)(*(torch.from_numpy(np.array(
            r[l // period], np.float32)).to(s.dtype)
            for r, s in zip(rc, c))))
    toks = _tokens(ctx["pcfg"], (B, 1), 4)
    pos = rng.integers(0, 16, (B,)).astype(np.int32)
    want, wcache = jax.jit(rcell.fn)(ctx["rparams"], rcache,
                                     jnp.asarray(toks), jnp.asarray(pos))
    got, gcache = pcell.fn(ctx["ptree"], pcache, torch.from_numpy(toks),
                           torch.from_numpy(pos))
    assert gcache is pcache                      # written in place
    np.testing.assert_allclose(_np(got), _np(want), **DECODE_TOL)
    for l, c in enumerate(gcache):
        for g, w in zip(c, wcache[f"block_{l % period}"]):
            np.testing.assert_allclose(_np(g.float()), _np(w[l // period]),
                                       atol=1e-2, rtol=1e-2)


def test_build_cell_materializes_on_the_mesh_device():
    mesh = make_mesh((1, 1), ("data", "model"), ["cpu"])
    cell = P_steps.build_cell("mamba2_130m", "decode_32k", mesh,
                              depth_override=1)
    small = dataclasses.replace(cell, args=dryrun.rank_share(cell))
    args = P_steps.materialize(small, small.args, "cpu")
    leaves = [t for _, t in _flat(args)]
    assert all(t.device.type == "cpu" for t in leaves)
    emb = args[0]["embed"]["embedding"]
    assert emb.dtype == torch.bfloat16 and emb.float().std() > 0.5
    assert all(int(t.abs().sum()) == 0 for t in (args[3],))


# ------------------------------------------------------------ flags


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "ssd_bf16"])
@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_reference_vec_matches_reference(case, bf16):
    Bn, Sn, H, Pd, N, chunk = case
    rng = np.random.default_rng(0)
    pad = (-Sn) % chunk                     # the mixer pads a ragged S
    x = rng.standard_normal((Bn, Sn + pad, H, Pd)).astype(np.float32)
    a = -np.abs(rng.standard_normal((Bn, Sn + pad, H))).astype(np.float32) \
        * 0.1
    Bm = rng.standard_normal((Bn, Sn + pad, N)).astype(np.float32)
    Cm = rng.standard_normal((Bn, Sn + pad, N)).astype(np.float32)
    for arr in (x, a, Bm, Cm):
        arr[:, Sn:] = 0
    r_flags.set_ssd_bf16(bf16)
    flags.set_ssd_bf16(bf16)
    try:
        want = r_ssd_vec(*map(jnp.asarray, (x, a, Bm, Cm)), chunk=chunk)
        got = ssd_reference_vec(*map(torch.from_numpy, (x, a, Bm, Cm)),
                                chunk=chunk)
    finally:
        r_flags.set_ssd_bf16(False)
        flags.set_ssd_bf16(False)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), atol=SSD_TOL[bf16],
                                   rtol=SSD_TOL[bf16])


@pytest.fixture
def roofline():
    flags.set_roofline(True)
    yield
    flags.set_roofline(False)


def test_roofline_cross_entropy_equals_chunked():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((2, 2048, 64)).astype(
        np.float32) * 3)
    labels = torch.from_numpy(rng.integers(0, 64, (2, 2048)))
    chunked = P_steps.cross_entropy(logits, labels)
    flags.set_roofline(True)
    try:
        whole = P_steps.cross_entropy(logits, labels)
    finally:
        flags.set_roofline(False)
    want = r_steps.cross_entropy(jnp.asarray(logits.numpy()),
                                 jnp.asarray(labels.numpy()))
    np.testing.assert_allclose(float(whole), float(chunked), rtol=1e-6)
    np.testing.assert_allclose(float(whole), float(want), rtol=1e-6)


def test_roofline_attention_equals_chunked(monkeypatch):
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2560, 4, 16)).astype(
        np.float32)) for _ in range(3))
    pos = torch.arange(2560)[None]
    calls = []
    monkeypatch.setattr(P_attention, "ref_attention_chunked",
                        lambda *a, **kw: calls.append(1) or
                        P_attention.ref_attention(*a[:5], **{
                            x: y for x, y in kw.items() if x != "chunk"}))
    chunked = P_attention.flash_or_ref(q, k, v, pos, pos, window=256)
    flags.set_roofline(True)
    try:
        whole = P_attention.flash_or_ref(q, k, v, pos, pos, window=256)
    finally:
        flags.set_roofline(False)
    assert calls == [1]                 # only the production route chunks
    monkeypatch.undo()
    chunked = P_attention.ref_attention_chunked(q, k, v, pos, pos,
                                                window=256)
    np.testing.assert_allclose(_np(whole), _np(chunked), atol=1e-5,
                               rtol=1e-5)


def test_roofline_moe_dispatch_in_one_chunk(monkeypatch):
    """Under ROOFLINE_MODE the tokens go in one dispatch chunk: the outputs
    equal the chunked route's (nothing drops at this width either way);
    the aux loss, summed per chunk, is the reference's on both routes."""
    import repro.models.moe as r_moe
    cfg = registry.get_config("granite_moe_1b_a400m", smoke=True)
    rcfg = r_registry.get_config("granite_moe_1b_a400m", smoke=True)
    monkeypatch.setattr(P_moe, "DISPATCH_CHUNK", 64)
    monkeypatch.setattr(r_moe, "DISPATCH_CHUNK", 64)
    rng = np.random.default_rng(7)
    d, E, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    arrs = [rng.standard_normal((256, d)).astype(np.float32),
            rng.standard_normal((d, E)).astype(np.float32) * 0.1,
            rng.standard_normal((E, d, 2, f)).astype(np.float32) * 0.05,
            rng.standard_normal((E, f, d)).astype(np.float32) * 0.05]
    sizes = []
    real = P_moe._moe_chunk
    monkeypatch.setattr(P_moe, "_moe_chunk", lambda xt, *a: sizes.append(
        xt.shape[0]) or real(xt, *a))
    got, want = {}, {}
    for mode in (False, True):
        flags.set_roofline(mode)
        r_flags.set_roofline(mode)
        try:
            got[mode] = P_moe._moe_tokens(*map(torch.from_numpy, arrs), cfg)
            want[mode] = r_moe._moe_tokens(*map(jnp.asarray, arrs), rcfg,
                                           ep=1, has_a2a=False)
        finally:
            flags.set_roofline(False)
            r_flags.set_roofline(False)
    assert sizes == [64] * 4 + [256]
    np.testing.assert_allclose(_np(got[True][0]), _np(got[False][0]),
                               atol=1e-5, rtol=1e-5)
    for mode in (False, True):
        np.testing.assert_allclose(_np(got[mode][0]), _np(want[mode][0]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(got[mode][1]),
                                   float(want[mode][1]), rtol=1e-5)


def test_ring_sync_dtype_flag_reaches_the_scheduler():
    from repro_torch.collectives import scheduler
    assert flags.RING_SYNC_DTYPE == "float32"
    assert not hasattr(scheduler, "RING_SYNC_DTYPE")
    flags.set_ring_sync_dtype("bfloat16")
    try:
        assert flags.ring_sync_dtype() is torch.bfloat16
    finally:
        flags.set_ring_sync_dtype("float32")
    with pytest.raises(ValueError):
        flags.set_ring_sync_dtype("float17")


# ------------------------------------------------------------ restore


def test_restore_from_an_abstract_tree_onto_a_cpu_mesh(tmp_path):
    rng = np.random.default_rng(8)
    tree = {"w": torch.from_numpy(rng.standard_normal((8, 6)).astype(
        np.float32)).to(torch.bfloat16),
        "opt": {"m": torch.from_numpy(rng.standard_normal(12).astype(
            np.float32)), "step": torch.tensor(7, dtype=torch.int32)}}
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(3, tree, extra={"k": 1})
    mesh = make_mesh((2,), ("data",), ["cpu"] * 2)
    like = {"w": torch.empty(8, 6, dtype=torch.bfloat16, device="meta"),
            "opt": {"m": ShapeDtypeStruct((12,), torch.float32),
                    "step": ShapeDtypeStruct((), torch.int32)}}
    sh = {"w": NamedSharding(mesh, P("data")),
          "opt": {"m": NamedSharding(mesh, P()),
                  "step": NamedSharding(mesh, P())}}
    got, extra = mgr.restore(3, like, shardings=sh)
    assert extra == {"k": 1}
    for path, want in _flat(tree):
        g = _leaf(got, path)
        assert g.device == mesh.devices.flat[0] and g.dtype == want.dtype
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16
                           else g, want.view(torch.int16)
                           if want.dtype == torch.bfloat16 else want)


def test_restore_of_a_meta_like_without_a_sharding_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(1, {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="needs a sharding"):
        mgr.restore(1, {"w": torch.empty(3, device="meta")})
