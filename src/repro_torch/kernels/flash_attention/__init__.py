"""Flash attention forward and backward as CUDA kernels (``kernel``) beside
their plain torch versions (``ref``), with the model-side entry (``ops``)."""
from .kernel import (DKV_TILE, DQ_TILE, FWD_TILE, BwdCall, build,
                     bwd_kernel_info, flash_bwd, flash_fwd, fwd_kernel_info,
                     tile_kind, visible_tiles)
from .ops import flash_attention
from .ref import attention_bwd_ref, attention_ref

__all__ = ["flash_attention", "flash_fwd", "flash_bwd", "BwdCall",
           "attention_ref", "attention_bwd_ref", "build", "FWD_TILE",
           "DQ_TILE", "DKV_TILE", "visible_tiles", "tile_kind",
           "fwd_kernel_info", "bwd_kernel_info"]
