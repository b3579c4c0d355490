"""Qwen2-VL 72B backbone [arXiv:2409.12191; hf Qwen/Qwen2-VL-72B].

80L d_model=8192 64H GQA kv=8 d_ff=29568 vocab=152064, M-RoPE
(temporal/height/width sections 16/24/24 of head_dim/2=64).
The vision frontend is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings for the first patch_frac of the sequence.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152_064,
    pattern=("attn",),
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    input_mode="mixed",
    patch_frac=0.25,
    tie_embeddings=False,
    source="arXiv:2409.12191; hf",
)
