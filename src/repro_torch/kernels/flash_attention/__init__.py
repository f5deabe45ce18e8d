"""Flash attention forward as a CUDA kernel (``kernel``) beside its plain
torch version (``ref``), with the model-side entry (``ops``)."""
from .kernel import build, flash_fwd
from .ops import flash_attention
from .ref import attention_ref

__all__ = ["flash_attention", "flash_fwd", "attention_ref", "build"]
