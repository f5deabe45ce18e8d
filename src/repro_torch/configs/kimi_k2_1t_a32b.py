"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, 384 experts top-8 — trillion-parameter MoE (paper-table config).
[arXiv:2501.kimi2]

Note: the assignment specifies GQA kv=8 (not MLA) and a uniform 61-layer MoE
stack; we follow the assignment numbers exactly.
"""
from ..config import LM_SHAPES, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=0,
    vocab_size=163840,
    attention="gqa",
    activation="swiglu",
    moe=MoEConfig(num_experts=384, experts_per_token=8, d_ff_expert=2048,
                  capacity_factor=1.25),
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="kimi-smoke",
    family="moe",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    attention="gqa",
    moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff_expert=64,
                  capacity_factor=1.5),
    tie_embeddings=False,
)

SHAPES = LM_SHAPES
SKIPS = {"long_500k": "pure full attention; skipped per assignment rule"}
