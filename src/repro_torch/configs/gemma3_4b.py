"""Gemma-3 4B [hf:google/gemma-3-4b-pt; unverified].

34L d_model=2560 8H GQA kv=4 head_dim=256 d_ff=10240 vocab=262144.
5:1 local:global layer pattern (window 1024), dual rope theta (local 10k,
global 1M), qk-norm, pre+post norms, 128k context target.
34 = 5 full periods of 6 + 4 remainder (unrolled local layers).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262_144,
    pattern=("attn_local",) * 5 + ("attn",),
    window=1024,
    rope_theta=1_000_000.0,
    local_rope_theta=10_000.0,
    qk_norm=True,
    post_norm=True,
    embed_scale=2560 ** 0.5,
    tie_embeddings=True,
    source="hf:google/gemma-3-4b-pt",
    notes="long_500k SKIPPED: the every-6th global full-attention layer "
          "makes 512k prefill O(S^2); see DESIGN §5.",
)
