"""mamba2-130m [ssm]: 24L d_model=768, attention-free SSD, vocab 50280,
ssm_state=128.  [arXiv:2405.21060]"""
from ..config import LM_SHAPES, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                      # pure mamba blocks, no MLP
    vocab_size=50280,
    attention="none",
    pos_emb="none",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=128),
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    num_layers=2,
    d_model=128,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    attention="none",
    pos_emb="none",
    ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=32, chunk_size=32),
)

SHAPES = LM_SHAPES
SKIPS: dict[str, str] = {}       # SSM: long_500k runs (constant state)
