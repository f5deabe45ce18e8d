"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) expert d_ff=512
vocab=49155, 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from ..config import LM_SHAPES, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=0,                      # every FFN is MoE
    vocab_size=49155,
    attention="gqa",
    activation="swiglu",
    moe=MoEConfig(num_experts=32, experts_per_token=8, d_ff_expert=512,
                  capacity_factor=1.25),
)

SMOKE = ModelConfig(
    name="granite-smoke",
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
)

SHAPES = LM_SHAPES
SKIPS = {"long_500k": "pure full attention; skipped per assignment rule"}
