"""MusicGen-medium backbone [arXiv:2306.05284; hf facebook/musicgen-medium].

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 — decoder-only over
EnCodec tokens.  The EnCodec tokenizer + text conditioning are STUBS per the
assignment: input_specs() supplies precomputed frame embeddings.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    pattern=("attn",),
    rope_theta=10_000.0,
    input_mode="embeds",
    tie_embeddings=True,
    source="arXiv:2306.05284; hf",
)
