"""The port's side of a MiniCPM configuration: its ``ModelConfig`` built
from the file's numbers, and the kernels it runs."""
from __future__ import annotations

import dataclasses
import math

KERNELS = ("flash_attention", "flash_decode")


def port_config(cfg: dict):
    """``repro_torch``'s config ``cfg["port_arch"]`` with every number of
    the file put in."""
    from repro_torch.configs import get_config
    base = get_config(cfg["port_arch"])
    d, n = cfg["hidden_size"], cfg["num_hidden_layers"]
    return dataclasses.replace(
        base,
        n_layers=n,
        d_model=d,
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=d // cfg["num_attention_heads"],
        d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"],
        pattern=("attn",),
        rope_theta=cfg["rope_theta"],
        embed_scale=float(cfg["scale_emb"]),
        residual_scale=cfg["scale_depth"] / math.sqrt(n),
        logit_divisor=d / cfg["dim_model_base"],
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"])
