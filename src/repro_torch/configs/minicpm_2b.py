"""MiniCPM-2B [arXiv:2404.06395; hf openbmb/MiniCPM-2B].

40L d_model=2304 36H (MHA, kv=36) d_ff=5760 vocab=122753, llama-like with
μP-style scaling: scale_emb=12, depth-scaled residuals (1.4/√40), logits
divided by d_model/256.  Trained with the WSD schedule (repro_torch.optim).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122_753,
    pattern=("attn",),
    rope_theta=10_000.0,
    embed_scale=12.0,
    residual_scale=1.4 / (40 ** 0.5),
    logit_divisor=2304.0 / 256.0,
    tie_embeddings=True,
    source="arXiv:2404.06395; hf",
    notes="WSD schedule arch; MHA (36 q heads shard unevenly over TP=16, "
          "GSPMD pads 36->48 lanes).",
)
