"""The port stands alone: no module of ``repro_torch`` and nothing in
``chip_smoke.py``, ``chip_variants.py`` (the kernel variants tool, which
holds the flash forward's) or ``chip_memory.py`` (where a launch cell's
peak memory goes) imports jax, ``ml_dtypes`` or the JAX package
``repro``."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "repro", "ml_dtypes"))
print(" ".join(names))
print(bad)
"""


def test_port_imports_no_jax_and_no_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
                       "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names, bad = proc.stdout.strip().split("\n")
    assert len(names.split()) >= 76, names
    for mod in ("core.netsim.control", "kernels.netsim_tick.window",
                "kernels.netsim_tick.ops", "kernels.netsim_tick.ref",
                "kernels.netsim_tick.tiled", "kernels._build",
                "kernels.switch_pipeline.kernel",
                "kernels.switch_pipeline.ref", "kernels.switch_pipeline.ops", "config", "configs.registry",
                "configs.h2o_danube_3_4b", "parallel.sharding",
                "models.params", "models.layers", "models.attention",
                "models.lm", "models.model", "models.convert",
                "kernels.flash_attention.kernel",
                "kernels.flash_attention.ops", "kernels.flash_attention.ref",
                "runtime.serve", "optim.adamw", "launch.steps",
                "data.pipeline", "checkpoint.manager", "runtime.train",
                "kernels.ssd.kernel", "kernels.ssd.ops", "kernels.ssd.ref",
                "models.ssm", "models.mla", "models.encdec", "launch.mesh",
                "parallel.spmd", "parallel.pipeline", "collectives.ring",
                "collectives.scheduler", "optim.compress", "launch.dryrun",
                "flags"):
        assert f"repro_torch.{mod}" in names, names
    assert bad == "[]", f"port pulled in {bad}"


def test_chip_smoke_imports_no_jax_and_no_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\s|\.|$)")
    src = (ROOT / "chip_smoke.py").read_text().splitlines()
    hits = [line for line in src if pat.match(line)]
    assert not hits, hits
    assert any("repro_torch" in line for line in src)


def test_chip_flash_imports_no_jax_and_no_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\s|\.|$)")
    src = (ROOT / "chip_variants.py").read_text().splitlines()
    hits = [line for line in src if pat.match(line)]
    assert not hits, hits
    assert any("repro_torch" in line for line in src)



def test_chip_memory_imports_no_jax_and_no_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\s|\.|$)")
    src = (ROOT / "chip_memory.py").read_text().splitlines()
    hits = [line for line in src if pat.match(line)]
    assert not hits, hits
    assert any("repro_torch" in line for line in src)
