"""``chip_smoke.py``'s pieces that need no card, for the tiled tick and the
switch scan: the build report of their kernels (from a crafted ptxas log),
where ``--against`` finds another commit's sources, and which interface it
calls another commit's library through (by its ``*_abi()`` tag; stub
libraries, nothing is launched).
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
