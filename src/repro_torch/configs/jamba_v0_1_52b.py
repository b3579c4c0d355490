"""Jamba v0.1 (52B) [arXiv:2403.19887; hf ai21labs/Jamba-v0.1].

32L d_model=4096 32H GQA kv=8 d_ff=14336 vocab=65536.
Period-8 blocks with attention at index 4 (1:7 attn:mamba interleave);
MoE (16 experts, top-2, d_ff=14336) every other layer (odd offsets).
The published depth: 52B parameters do not fit one 80 GB card, so the
scripts that run it on the card cut ``n_layers`` themselves and say so.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65_536,
    pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
             "mamba"),
    moe_period=2,
    moe_offset=1,
    n_experts=16,
    experts_per_token=2,
    expert_d_ff=14336,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2403.19887; hf",
)
