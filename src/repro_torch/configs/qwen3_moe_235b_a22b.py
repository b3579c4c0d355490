"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-235B-A22B; hf-verified family].

94L d_model=4096 64H GQA kv=4 vocab=151936, MoE: 128 experts top-8,
expert d_ff=1536, no shared expert, qk-norm (qwen3), head_dim=128.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,            # expert FFN width
    vocab_size=151_936,
    pattern=("attn",),
    moe_period=1,
    n_experts=128,
    experts_per_token=8,
    expert_d_ff=1536,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-235B-A22B",
)
