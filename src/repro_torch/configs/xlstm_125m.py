"""xLSTM-125M [arXiv:2405.04517; unverified].

12L d_model=768 4H vocab=50304, d_ff=0 (cells carry their own projections).
mLSTM (matrix memory, chunkwise-parallel) with interleaved sLSTM
(recurrent scalar memory) at a 5:1 ratio — the paper's xLSTM[a:b] notation.
Attention-free ⇒ runs the long_500k cell (O(1)-state decode).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
