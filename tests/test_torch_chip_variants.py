"""``chip_variants.py``'s variants still apply to the sources they patch:
each changes its kernel's main source, so a later edit of a kernel that
leaves a variant behind shows here and not first on the card."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_variants",
                                               ROOT / "chip_variants.py")
V = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(V)

CASES = [(kernel, name) for kernel, (_, _, variants, _) in V.KERNELS.items()
         for name in variants]


@pytest.mark.parametrize("kernel,name", CASES,
                         ids=[f"{k}-{n}" for k, n in CASES])
def test_variant_changes_the_source(kernel, name):
    csrc, main, variants, _ = V.KERNELS[kernel]
    text = (csrc / main).read_text()
    assert variants[name](text) != text


def test_a_variant_that_no_longer_applies_stops_the_run(monkeypatch):
    csrc, main, variants, shown = V.KERNELS["ssd"]
    gone = dict(variants, gone=V._replace(("no such line", "")))
    monkeypatch.setitem(V.KERNELS, "ssd", (csrc, main, gone, shown))
    with pytest.raises(SystemExit, match=r"\['gone'\] do not apply"):
        V.variant_sources("ssd")
    assert set(V.variant_sources("flash")) == set(V.FLASH_VARIANTS)
