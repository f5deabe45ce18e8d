"""``chip_smoke.py``'s pieces that need no card.  For the tiled tick and
the switch scan: the build report of their kernels (from a crafted ptxas
log), where ``--against`` finds another commit's sources, and which
interface it calls another commit's library through (by its ``*_abi()``
tag; stub libraries, nothing is launched).  For the lanes, moe and jamba
phases: the dropped-assignment counter against a hand-built routing, and
the lane-split check, which a planted fault (shares that renumber their
lanes) must fail.  For the launch phase: the memory band on numbers fed
in (the true prediction passes, both planted faults fail), its place in
``PHASES`` and its dry-run task in this process.
"""
import importlib.util
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.netsim_tick import tiled  # noqa: E402
from repro_torch.kernels.switch_pipeline import kernel as SK  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCAN_KERNELS = {"netsim_tiled": ("_Z12tiled_sweep09TiledArgs",
                                 "_Z12tiled_sweep19TiledArgs",
                                 "_Z12tiled_sweep29TiledArgs",
                                 "_Z12tiled_sweep39TiledArgs",
                                 "_Z11tiled_flush9TiledArgs"),
                "switch_pipeline": ("_Z22switch_pipeline_kernel6SpArgs",)}


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke(cs):
    return cs.Smoke(torch)


def _log(names, spill_in=None, leave_out=None):
    out = ""
    for n in names:
        if n == leave_out:
            continue
        spill = 8 if n == spill_in else 0
        out += (f"ptxas info    : Compiling entry function '{n}' for "
                f"'sm_90a'\nptxas info    : Function properties for {n}\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, "
                f"{spill} bytes spill loads\nptxas info    : Used 40 "
                f"registers, used 1 barriers, 128 bytes smem\n")
    return out


def _libs(**kw):
    return {lib: (None, _log(names, **kw))
            for lib, names in SCAN_KERNELS.items()}


def test_build_report_names_the_scan_kernels(smoke, capsys):
    """One line per kernel, with the tiled tick's largest dynamic shared
    memory at the multipod shapes (what tiled_smem_bytes gives)."""
    smoke.scan_build_report(_libs())
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6
    for names in SCAN_KERNELS.values():
        for n in names:
            short = n.split("_Z")[1].lstrip("0123456789")
            kname = short[:short.index("9Tiled")] if "Tiled" in short \
                else "switch_pipeline_kernel"
            assert any(f": {kname}: 40 registers" in ln for ln in lines), n
    want = f"{tiled.tiled_smem_bytes(1793, 1, 65):,} bytes at multipod512"
    assert any(want in ln for ln in lines)


@pytest.mark.parametrize("fault", ["spill", "missing"])
def test_build_report_fails_on_a_spill_or_a_missing_kernel(smoke, fault):
    kw = dict(spill_in="_Z12tiled_sweep29TiledArgs") if fault == "spill" \
        else dict(leave_out="_Z22switch_pipeline_kernel6SpArgs")
    with pytest.raises(SystemExit, match="spills|no ptxas report"):
        smoke.scan_build_report(_libs(**kw))


def test_against_finds_a_tree_or_an_ssd_source(cs, tmp_path):
    kernels = tmp_path / "tree" / "src" / "repro_torch" / "kernels"
    for pkg, lib in (("ssd", "ssd"), ("netsim_tick", "netsim_tiled"),
                     ("switch_pipeline", "switch_pipeline")):
        (kernels / pkg / "csrc").mkdir(parents=True)
        (kernels / pkg / "csrc" / f"{lib}.cu").write_text("")
    found = cs.against_sources(tmp_path / "tree")
    assert found == {
        "ssd": kernels / "ssd" / "csrc",
        "netsim_tiled": kernels / "netsim_tick" / "csrc",
        "switch_pipeline": kernels / "switch_pipeline" / "csrc"}
    (tmp_path / "one").mkdir()
    (tmp_path / "one" / "ssd.cu").write_text("")
    assert cs.against_sources(tmp_path / "one") == {
        "ssd": (tmp_path / "one").resolve()}
    assert cs.against_sources(tmp_path) == {}


def _stub(names, abi=None, prefix=""):
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                   for n in names})
    if abi is not None:
        setattr(lib, f"{prefix}_abi", lambda: abi)
    return lib


@pytest.mark.parametrize("tag", [None, "shipped", 7])
def test_switch_against_takes_the_interface_its_tag_names(smoke, tag):
    """A library with no switch_pipeline_abi() is called through the first
    port's launch (9 pointers, no workspace: 17 arguments); one tagged
    kernel.ABI through the wrapper; any other tag is refused before
    anything is called."""
    lib = _stub(("switch_pipeline_launch", "switch_pipeline_ws_bytes"),
                None if tag is None else SK.ABI if tag == "shipped" else tag,
                "switch_pipeline")
    trace = [torch.zeros(8, dtype=dt) for dt in (
        torch.int32, torch.float32, torch.int32, torch.int32, torch.float32)]
    if tag == 7:
        with pytest.raises(SystemExit, match="switch_pipeline_abi"):
            smoke.switch_against_call(lib, trace)
        return
    call = smoke.switch_against_call(lib, trace)
    assert callable(call)
    if tag is None:
        assert len(lib.switch_pipeline_launch.argtypes) == 17
    else:
        assert not hasattr(lib.switch_pipeline_launch, "argtypes")


@pytest.mark.parametrize("tag", [None, "shipped", 7])
def test_tiled_against_takes_the_interface_its_tag_names(smoke, tag):
    """The same for the tiled tick: no netsim_tiled_abi() is the first
    port's interface (bound here: the launch's four pointers and its own
    shared-memory formula); tiled.ABI the wrapper's; others refused."""
    lib = _stub(("netsim_tiled_launch", "netsim_tiled_smem_bytes"),
                None if tag is None else tiled.ABI if tag == "shipped"
                else tag, "netsim_tiled")
    if tag == 7:
        with pytest.raises(SystemExit, match="netsim_tiled_abi"):
            smoke.tiled_against_call(lib, (), {})
        return
    call = smoke.tiled_against_call(lib, (), {})
    assert callable(call)
    if tag is None:
        assert len(lib.netsim_tiled_launch.argtypes) == 4
        assert len(lib.netsim_tiled_smem_bytes.argtypes) == 3
    else:
        assert not hasattr(lib.netsim_tiled_launch, "argtypes")


# ------------------------------------- the lanes, moe and jamba phases

def test_moe_drop_counter_counts_a_hand_built_routing(cs, monkeypatch):
    """moe_drop_counter's count against a routing built by hand: 4
    experts, top-2, 4 tokens at capacity factor 1 (C_send 8, C_loc 2).
    Expert 0 takes 4 assignments (2 drop), expert 1 three (1 drops)."""
    import repro_torch.models.moe as moe
    from repro_torch.config import ModelConfig, MoEConfig
    cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=8,
                      num_heads=2, num_kv_heads=2, d_ff=0, vocab_size=16,
                      moe=MoEConfig(num_experts=4, experts_per_token=2,
                                    d_ff_expert=4, capacity_factor=1.0))
    assert moe.capacities(cfg, 4) == (8, 2)
    idx = torch.tensor([[0, 1], [1, 0], [0, 2], [1, 0]])
    gates = torch.full((4, 2), 0.5)
    monkeypatch.setattr(moe, "_route", lambda xt, router, c: (
        gates, idx, torch.zeros(())))
    p = {"router": torch.zeros(8, 4), "wi": torch.zeros(4, 8, 2, 4),
         "wo": torch.zeros(4, 4, 8)}
    slots = moe._slots
    with cs.moe_drop_counter(moe) as seen:
        moe.moe_block(p, torch.ones(1, 4, 8), cfg)
        moe.moe_block(p, torch.ones(1, 4, 8), cfg)
    assert moe._slots is slots
    assert [int(n) for n in seen] == [3, 3]
    assert cs.per_layer(torch, seen, 2) == [3, 3]
    assert cs.per_layer(torch, seen, 1) == [6]


def _split_grid(T, devices):
    topo = T.make_leaf_spine(8, 2, 2)
    b = T.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(8)), ring_size=4, chunk_bytes=2e5,
                   passes=1, barrier=False)
    cfg = T.SimParams(n_ticks=200, window=8, record_every=10)
    struct, knobs = T.grid_from_params([
        cfg._replace(sym_on=bool(i % 2), pq_on=bool(i // 2))
        for i in range(4)])
    kw = dict(device="cpu") if devices is None else dict(devices=devices)
    return T.simulate_grid(topo, b.build(), struct, knobs, [0, 3],
                           routing="ecmp", **kw)


def test_lane_split_check_passes_a_split_and_fails_a_planted_fault(cs):
    """8 lanes over the CPU named 3 times (shares of 3, 3, 2): the split
    passes lane_split_check against the one-device run; with each share
    renumbering its lanes from 0 (renumbered_shares) the shares past lane
    0 run the first lanes' seeds and knob points, and the check fails."""
    import repro_torch.core.netsim as T
    import repro_torch.core.netsim.simulator as sim
    one = _split_grid(T, None)
    ok, msg = cs.lane_split_check(torch, _split_grid(T, ["cpu"] * 3), one)
    assert ok and "bit-equal" in msg and "ts_qmax 0 of" in msg, msg
    run = sim._run_lanes
    with cs.renumbered_shares(sim):
        bad = _split_grid(T, ["cpu"] * 3)
    assert sim._run_lanes is run
    ok, msg = cs.lane_split_check(torch, bad, one)
    assert not ok and "differ in" in msg, msg


def test_new_phases_are_listed_in_order(cs):
    p = list(cs.PHASES)
    assert p.index("mamba") < p.index("moe") < p.index("jamba") < \
        p.index("mla") < p.index("vlm") < p.index("whisper") < \
        p.index("goldens") and p.index("multipod") < p.index("lanes") < \
        p.index("ring") < p.index("dp") < p.index("ep") < \
        p.index("gpipe") < p.index("grid512")
    assert all(hasattr(cs.Smoke, name) for name in p)


# ----------------------------------- the ring, dp, ep and gpipe phases

@pytest.mark.parametrize("n", [4, 8])
def test_ring_cases_over_cpu_ranks(cs, n):
    """The ring phase's cases over the CPU named n times: each within its
    tolerance of the plain sum, with 2(N-1) ppermutes per ring per
    channel; the card's run is held bit-equal to these."""
    cases = cs.ring_cases(torch, ["cpu"] * n, n)
    assert len(cases) == 30          # 31 on the card, with the 256 MiB case
    for name, case in cases.items():
        y, counts, want, plain, _ = case
        assert counts == want, name
        assert cs.ring_case_ok(case), name
        assert plain is None or y.shape == plain.shape, name


@pytest.mark.parametrize("fault", ["shifted by two", "last step dropped"])
@pytest.mark.parametrize("n", [4, 8])
def test_planted_ring_faults_fail_and_restore(cs, fault, n):
    import repro_torch.collectives.ring as ring
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.spmd import P, shard_map
    mesh = make_mesh((n,), ("data",), ["cpu"] * n)
    x = torch.randn(n, 16, generator=torch.Generator().manual_seed(0))
    plain = x.sum(0, keepdim=True)
    saved = ring._perm, ring.ring_reduce_scatter
    with cs.planted_ring(ring, fault):
        y = shard_map(lambda a: ring.ring_all_reduce(a, "data"), mesh=mesh,
                      in_specs=P("data"), out_specs=P())(x)
    assert (ring._perm, ring.ring_reduce_scatter) == saved
    assert not torch.allclose(y, plain, rtol=cs.RING_TOL[0],
                              atol=cs.RING_TOL[1])
    y = shard_map(lambda a: ring.ring_all_reduce(a, "data"), mesh=mesh,
                  in_specs=P("data"), out_specs=P())(x)
    assert torch.allclose(y, plain, rtol=1e-5, atol=1e-5)


def test_ep_drop_counter_counts_both_capacities(cs):
    """Granite's smoke MoE over (data 2, model 4) CPU ranks at capacity
    0.25: the counter sees drops at the send buffers and at the experts,
    and equals a count from the routing; nothing at capacity 8."""
    import dataclasses
    import repro_torch.models.moe as moe
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    model = build_model(registry.get_config("granite_moe_1b_a400m",
                                            smoke=True), device="cpu")
    cfg = model.cfg
    p = {k: v.detach() for k, v in model.blocks[0].moe.items()}
    x = torch.randn(2, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(
                        torch.bfloat16)
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    slots = moe.ep_slots
    for cf, dropping in ((8.0, False), (0.25, True)):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        with torch.no_grad(), cs.ep_drop_counter(moe) as seen:
            moe.moe_block(p, x, c, None, mesh)
        assert moe.ep_slots is slots
        send = int(torch.stack(seen["send"]).sum())
        expert = int(torch.stack(seen["expert"]).sum())
        assert len(seen["send"]) == len(seen["expert"]) == 8
        assert (send > 0) == dropping and (expert >= 0)
        if not dropping:
            assert expert == 0


def test_gpipe_stage_block_equals_the_model_block(cs):
    """danube_block on a stage's slice of stacked_blocks gives the bits of
    LM._apply_block on that layer (smoke width, CPU)."""
    from repro_torch.configs import registry
    from repro_torch.models import build_model
    model = build_model(registry.get_config("h2o_danube_3_4b", smoke=True),
                        device="cpu")
    stages = cs.stacked_blocks(torch, list(model.blocks))
    x = torch.randn(1, 128, model.cfg.d_model,
                    generator=torch.Generator().manual_seed(2)).to(
                        torch.bfloat16)
    pos = torch.arange(128, dtype=torch.int32).expand(1, 128)
    with torch.no_grad():
        for i, bp in enumerate(model.blocks):
            got = cs.danube_block(model.cfg, {
                k: {n: t[i] for n, t in v.items()}
                for k, v in stages.items()}, x, pos)
            want, _ = model._apply_block(bp, i, x, pos)
            assert torch.equal(got, want), i


def test_flash_calls_by_stream_counts_and_restores(cs, monkeypatch):
    import repro_torch.kernels.flash_attention.ops as ops
    fwd, bwd = ops.flash_fwd, ops.flash_bwd
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=7))
    q = torch.randn(1, 128, 2, 16, requires_grad=True)
    with cs.flash_calls_by_stream(torch, ops) as calls:
        ops.flash_attention(q, q, q).sum().backward()
    assert (ops.flash_fwd, ops.flash_bwd) == (fwd, bwd)
    assert calls == {("fwd", 7): 1, ("bwd", 7): 1}


# ------------------------------------------------------------ launch

# a mamba2 decode_32k prediction on one card, bytes (the dry-run's record
# on a (1, 1) mesh: the cache, 2.45 GB, is donated and aliased)
DECODE_MEM = {"argument": 2_706_890_240, "output": 2_462_384_128,
              "alias": 2_449_473_536, "temp": 397_410_304}
DECODE_CACHE = 2_449_473_536


def test_launch_is_listed_after_gpipe(cs):
    p = list(cs.PHASES)
    assert p.index("gpipe") < p.index("launch") < p.index("grid512")
    assert cs.LAUNCH_FAULTS == ("donation ignored", "cache dropped")


@pytest.mark.parametrize("off", [-0.14, 0.0, 0.1, 0.149])
def test_memory_band_passes_the_true_prediction(cs, off):
    total = DECODE_MEM["argument"] + DECODE_MEM["output"] - \
        DECODE_MEM["alias"] + DECODE_MEM["temp"]
    ok, rel = cs.memory_band(int(total * (1 + off)), total)
    assert ok and rel == pytest.approx(abs(off), abs=1e-9)


@pytest.mark.parametrize("fault", ["donation ignored", "cache dropped"])
def test_memory_band_fails_the_planted_faults(cs, fault):
    true = DECODE_MEM["argument"] + DECODE_MEM["output"] - \
        DECODE_MEM["alias"] + DECODE_MEM["temp"]
    wrong = cs.planted_memory(DECODE_MEM, fault, DECODE_CACHE)
    ok, rel = cs.memory_band(true, wrong)
    assert not ok and rel > 2 * cs.LAUNCH_BAND
    with pytest.raises(ValueError):
        cs.planted_memory(DECODE_MEM, "no such fault", DECODE_CACHE)


def test_launch_task_predicts_a_cell_on_meta(cs):
    """The launch phase's worker task: the meta prediction of mamba2's
    decode cell on one device, whose donated cache is aliased."""
    rec = cs.launch_task(("predict", "mamba2_130m", "decode_32k", (1, 1),
                          1))
    mem = rec["memory"]
    assert mem["alias"] > 0 and not mem["temp_at_full_model_width"]
    assert mem["per_device_total"] == mem["argument"] + mem["output"] - \
        mem["alias"] + mem["temp"]
    assert rec["flops_per_device"] > 0
    items = list(cs._tree_items({"a": [torch.zeros(2), (torch.ones(1),)],
                                 "b": None}))
    assert [p for p, _ in items] == [("a", 0), ("a", 1, 0)]
