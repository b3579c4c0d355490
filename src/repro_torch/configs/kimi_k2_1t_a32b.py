"""Kimi K2 (1T total, 32B active) [arXiv:2501.*; paper-table, unverified].

61L d_model=7168 64H GQA kv=8 vocab=163840, MoE: 384 experts top-8 with
expert d_ff=2048 + 1 shared expert.  The assignment table specifies GQA
(kv=8); the real model uses MLA — we follow the table (noted in DESIGN §5).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,            # expert FFN width (table value)
    vocab_size=163_840,
    pattern=("attn",),
    moe_period=1,
    n_experts=384,
    experts_per_token=8,
    expert_d_ff=2048,
    n_shared_experts=1,
    rope_theta=50_000.0,
    tie_embeddings=False,
    source="arXiv:2501.kimi2 (paper table)",
    notes="Trillion-param MoE: EP=16 over 'model' axis (24 experts/chip), "
          "FSDP over 'data'. head_dim=112=7168/64.",
)
