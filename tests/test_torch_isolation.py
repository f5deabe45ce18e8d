"""The port stands alone: no module of ``repro_torch`` and nothing in
``chip_smoke.py`` imports jax or the JAX package ``repro``."""
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
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
                       "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.strip().split(" ", 1)
    assert int(n) >= 14, proc.stdout
    assert bad == "[]", f"port pulled in {bad}"


def test_chip_smoke_imports_no_jax_and_no_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\s|\.|$)")
    src = (ROOT / "chip_smoke.py").read_text().splitlines()
    hits = [line for line in src if pat.match(line)]
    assert not hits, hits
    assert any("repro_torch" in line for line in src)
