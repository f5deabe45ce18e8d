"""minicpm3-4b [dense]: 62L d_model=2560 40H MLA d_ff=6400 vocab=73448.
[hf:openbmb/MiniCPM3-4B]"""
from ..config import LM_SHAPES, MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=96,                  # qk_nope + qk_rope
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    activation="swiglu",
    logit_softcap=0.0,
)

SMOKE = ModelConfig(
    name="minicpm3-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=48,
    d_ff=256,
    vocab_size=512,
    attention="mla",
    mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
)

SHAPES = LM_SHAPES
SKIPS = {"long_500k": "pure full attention (MLA): O(S^2) prefill; skipped per "
                      "assignment rule, noted in DESIGN.md"}
