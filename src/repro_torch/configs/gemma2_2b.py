"""Gemma-2 2B [arXiv:2408.00118; hf google/gemma-2-2b].

26L d_model=2304 8H GQA kv=4 head_dim=256 d_ff=9216 vocab=256000.
Alternating local(4096)/global attention, logit softcap 50 (attn) / 30
(final), pre+post RMSNorm, embeddings scaled by √d_model.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    pattern=("attn_local", "attn"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    embed_scale=2304 ** 0.5,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
    notes="8 q heads < TP16: attention TP falls back to head_dim (256) "
          "sharding per DESIGN §6.",
)
