"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936;
M-RoPE, dynamic resolution.  Vision frontend is a STUB (prefill consumes
precomputed patch embeddings + (t,h,w) position triples). [arXiv:2409.12191]"""
from ..config import LM_SHAPES, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    attention="gqa",
    activation="swiglu",
    pos_emb="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    frontend="vision_stub",
)

SMOKE = ModelConfig(
    name="qwen2vl-smoke",
    family="vlm",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    attention="gqa",
    pos_emb="mrope",
    mrope_sections=(4, 6, 6),
    frontend="vision_stub",
)

SHAPES = LM_SHAPES
SKIPS = {"long_500k": "pure full attention; skipped per assignment rule"}
