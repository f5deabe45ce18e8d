"""Registry of the 10 assigned architectures (+ the paper's netsim config).

Each module exposes CONFIG (the exact assigned full config), SMOKE (a reduced
same-family config for CPU smoke tests), and SHAPES (the assigned input-shape
cells, with skips noted).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "mamba2_130m",
    "minicpm3_4b",
    "h2o_danube_3_4b",
    "nemotron_4_15b",
    "nemotron_4_340b",
    "granite_moe_1b_a400m",
    "kimi_k2_1t_a32b",
    "whisper_large_v3",
    "jamba_v0_1_52b",
    "qwen2_vl_2b",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    return name


def get_module(name: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(name)}")


def get_config(name: str, smoke: bool = False):
    mod = get_module(name)
    return mod.SMOKE if smoke else mod.CONFIG


def get_shapes(name: str):
    return get_module(name).SHAPES


def all_cells():
    """Yield (arch, ShapeSpec, skip_reason|None) for the 40 assigned cells."""
    for a in ARCHS:
        mod = get_module(a)
        for spec in mod.SHAPES:
            skip = mod.SKIPS.get(spec.name) if hasattr(mod, "SKIPS") else None
            yield a, spec, skip
