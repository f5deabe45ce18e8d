"""The switch pipeline's entry point (``repro/kernels/switch_pipeline/
ops.py``): the kernel's wrapper, re-exported from :mod:`.kernel`.  CPU
tensors take its plain version, CUDA tensors the kernel."""
from __future__ import annotations

from .kernel import switch_pipeline

__all__ = ["switch_pipeline"]
