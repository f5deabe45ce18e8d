"""The Mamba-2 SSD chunked scan as a CUDA kernel (``kernel``) beside its
plain torch versions (``ref``), with the model-side entry (``ops``)."""
from .kernel import build, ssd_chunked
from .ops import ssd
from .ref import segsum_exp, ssd_chunked_ref, ssd_reference

__all__ = ["ssd", "ssd_chunked", "ssd_chunked_ref", "ssd_reference",
           "segsum_exp", "build"]
