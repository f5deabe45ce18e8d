"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536; Mamba+attention 1:7 interleave, MoE 16 experts top-2 on every
other layer. [arXiv:2403.19887]"""
from ..config import LM_SHAPES, ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    attention="gqa",
    attn_every=8,                # 1 attention layer per 8 (1:7 ratio)
    activation="swiglu",
    moe=MoEConfig(num_experts=16, experts_per_token=2, d_ff_expert=14336,
                  capacity_factor=1.25),
    moe_every=2,                 # MoE on every other layer
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk_size=128),
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    num_layers=8,                # one full period
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    attention="gqa",
    attn_every=8,
    moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff_expert=128,
                  capacity_factor=1.5),
    moe_every=2,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk_size=32),
)

SHAPES = LM_SHAPES
SKIPS: dict[str, str] = {}  # hybrid SSM: long_500k runs
