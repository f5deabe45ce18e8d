"""``chip_smoke.py``'s pieces that need no card.  For the tiled tick and
the switch scan: the build report of their kernels (from a crafted ptxas
log), where ``--against`` finds another commit's sources, and which
interface it calls another commit's library through (by its ``*_abi()``
tag; stub libraries, nothing is launched).  For the lanes, moe and jamba
phases: the dropped-assignment counter against a hand-built routing, and
the lane-split check, which a planted fault (shares that renumber their
lanes) must fail.
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
        p.index("goldens") and p.index("multipod") < p.index("lanes")
    assert all(hasattr(cs.Smoke, name) for name in p)
