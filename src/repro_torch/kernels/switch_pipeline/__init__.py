"""The Alg. 1 switch data plane as a CUDA kernel (``kernel``) beside its
plain torch version and the ``core/symphony.py`` oracle (``ref``)."""
from .kernel import build, switch_pipeline
from .ref import LOG2_LUT, lut_log2, pipeline_plain, pipeline_ref

__all__ = ["switch_pipeline", "build", "pipeline_plain", "pipeline_ref",
           "lut_log2", "LOG2_LUT"]
