"""The port's side of a Jamba configuration: its ``ModelConfig`` built
from the file's numbers, and the kernels it runs."""
from __future__ import annotations

import dataclasses

KERNELS = ("flash_attention", "flash_decode", "mamba_scan")


def port_config(cfg: dict):
    """``repro_torch``'s config ``cfg["port_arch"]`` with every number of
    the file put in.  The port fixes mamba's dt rank at d // 16, so a file
    that says otherwise is refused."""
    from repro_torch.configs import get_config
    base = get_config(cfg["port_arch"])
    d, per = cfg["hidden_size"], cfg["attn_layer_period"]
    if cfg["mamba_dt_rank"] != max(1, d // 16):
        raise ValueError(f"the port's dt rank is d // 16 = {d // 16}, "
                         f"the file says {cfg['mamba_dt_rank']}")
    return dataclasses.replace(
        base,
        n_layers=cfg["num_hidden_layers"],
        d_model=d,
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=d // cfg["num_attention_heads"],
        d_ff=cfg["intermediate_size"],
        expert_d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"],
        pattern=tuple("attn" if i == cfg["attn_layer_offset"] else "mamba"
                      for i in range(per)),
        moe_period=cfg["expert_layer_period"],
        moe_offset=cfg["expert_layer_offset"],
        n_experts=cfg["num_experts"],
        experts_per_token=cfg["num_experts_per_tok"],
        capacity_factor=cfg["capacity_factor"],
        ssm_state=cfg["mamba_d_state"],
        ssm_conv=cfg["mamba_d_conv"],
        ssm_expand=cfg["mamba_expand"],
        rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"])
