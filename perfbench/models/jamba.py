"""Jamba in the reference's terms, from a configuration file's keys (the
names of the published config.json): blocks of ``attn_layer_period``
layers with attention at ``attn_layer_offset`` and mamba elsewhere; the
routed experts at every ``expert_layer_period``-th layer from
``expert_layer_offset``, a dense SwiGLU in the others."""
from __future__ import annotations

from perfbench.reference.decoder import Plan


def plan(cfg: dict) -> Plan:
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        attn = i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]
        off, per = cfg["expert_layer_offset"], cfg["expert_layer_period"]
        moe = i >= off and (i - off) % per == 0
        layers.append(("attention" if attn else "mamba",
                       "moe" if moe else "ffn"))
    vocab = cfg["vocab_size"]
    dims = dict(d=d, heads=heads, kv_heads=cfg["num_key_value_heads"],
                hd=d // heads, d_ff=cfg["intermediate_size"],
                experts=cfg["num_experts"],
                top_k=cfg["num_experts_per_tok"],
                capacity_factor=cfg["capacity_factor"],
                d_state=cfg["mamba_d_state"], d_conv=cfg["mamba_d_conv"],
                expand=cfg["mamba_expand"], dt_rank=cfg["mamba_dt_rank"],
                theta=cfg["rope_theta"], eps=cfg["rms_norm_eps"],
                vocab=vocab, padded_vocab=-(-vocab // 256) * 256,
                tied=cfg["tie_word_embeddings"], embed_scale=1.0,
                residual_scale=1.0, logit_divisor=1.0)
    return Plan(layers=layers, dims=dims)
