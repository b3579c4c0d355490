"""MiniCPM in the reference's terms, from a configuration file's keys (the
names of the published config.json): a llama-like stack of attention and
dense SwiGLU layers with its muP scales: embeddings times ``scale_emb``,
each block's output times ``scale_depth / sqrt(layers)``, and the logits
divided by ``hidden_size / dim_model_base``.

The embedding table, which is also the head, is drawn at std 0.0025: at
0.02 the scaled embedding of a token outweighs what the layers add, so
the head gives back the input token by a margin that no rounding moves,
and the check could tell no precision from another."""
from __future__ import annotations

import math

from perfbench.reference.decoder import Plan

EMBED_STD = 0.0025


def plan(cfg: dict) -> Plan:
    d, heads, n = (cfg["hidden_size"], cfg["num_attention_heads"],
                   cfg["num_hidden_layers"])
    vocab = cfg["vocab_size"]
    dims = dict(d=d, heads=heads, kv_heads=cfg["num_key_value_heads"],
                hd=d // heads, d_ff=cfg["intermediate_size"],
                theta=cfg["rope_theta"], eps=cfg["rms_norm_eps"],
                vocab=vocab, padded_vocab=-(-vocab // 256) * 256,
                tied=cfg["tie_word_embeddings"],
                embed_scale=float(cfg["scale_emb"]),
                residual_scale=cfg["scale_depth"] / math.sqrt(n),
                logit_divisor=d / cfg["dim_model_base"],
                embed_std=EMBED_STD)
    return Plan(layers=[("attention", "ffn")] * n, dims=dims)
