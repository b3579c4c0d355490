"""Model configuration: the same fields and derived properties as the JAX
package's ``repro.models.config``, copied so the port imports nothing of it.

The layer stack is described by a repeating ``pattern`` of block kinds.  The
port ships the ``attn`` kind with a dense FFN (llama3.2-1b, minicpm-2b), the
sliding-window ``attn_local`` kind with per-kind rope theta (gemma2-2b,
gemma3-4b), the xLSTM kinds ``mlstm`` and ``slstm`` (xlstm-125m), and the
``mamba`` kind with the single-shard MoE (jamba-v0.1-52b, qwen3-moe), and
the three input modes with M-RoPE (qwen2-vl-72b, musicgen-medium).
``param_count`` is copied as it stands, including its mLSTM term
``3·di²/4`` where ``mlstm_specs`` holds three ``di×di`` projections, its
mamba term, which counts ``di·(2N + 2)`` for ``w_bcdt``, ``w_dt``,
``dt_bias``, ``a_log`` and ``d_skip`` where ``mamba_specs`` holds
``di·(2N + dt_rank) + dt_rank·di + di·N + 2·di``, and its norms: three a
layer where an attention layer's specs hold two, and no post norms.
``active_param_count`` subtracts the unpicked experts from that count, so
it carries the same miscounts.  ``ShapeConfig`` and ``ALL_SHAPES`` are the
reference's four input-shape cells.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default: d_model // n_heads

    # ---- layer pattern ------------------------------------------------
    # Block kinds cycled over layers: "attn" (+MLP), "attn_local",
    # "mamba", "mlstm", "slstm".  len(pattern) is the period.
    pattern: Tuple[str, ...] = ("attn",)
    window: int = 4096               # sliding window for attn_local
    # MoE placement: layer i uses experts iff (i % moe_period == moe_offset)
    # and i >= moe_first_layer.  moe_period=0 disables MoE entirely.
    moe_period: int = 0
    moe_offset: int = 0

    # ---- attention details ---------------------------------------------
    rope_theta: float = 10_000.0
    local_rope_theta: Optional[float] = None  # gemma3 dual-theta
    mrope: bool = False              # qwen2-vl multimodal 3-section RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    attn_softcap: float = 0.0        # gemma2 logit soft-capping
    final_softcap: float = 0.0
    qk_norm: bool = False            # gemma3
    post_norm: bool = False          # gemma2/3 post-block RMSNorm

    # ---- MoE ------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0             # defaults to d_ff when MoE is on
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # ---- SSM (mamba) ------------------------------------------------------
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2

    # ---- xLSTM -----------------------------------------------------------
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # ---- scaling tweaks (minicpm μP-ish, gemma) ---------------------------
    embed_scale: float = 1.0         # multiply embeddings (gemma √d, minicpm 12)
    residual_scale: float = 1.0      # scale block outputs (minicpm depth-scale)
    logit_divisor: float = 1.0       # divide final logits (minicpm d/256)
    tie_embeddings: bool = True

    # ---- modality frontend stub -------------------------------------------
    # tokens: ids -> embedding table;  embeds: precomputed frame embeddings
    # mixed:  patch_embeds prefix + token ids (VLM)
    input_mode: str = "tokens"
    patch_frac: float = 0.25         # VLM: fraction of seq that is patches

    # ---- numerics ----------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    source: str = ""
    notes: str = ""

    # ------------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as the JAX package pads it."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def full_pattern(self) -> Tuple[str, ...]:
        """Pattern expanded to n_layers (whole periods + remainder)."""
        p = []
        while len(p) < self.n_layers:
            p.extend(self.pattern)
        return tuple(p[: self.n_layers])

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def remainder_layers(self) -> int:
        return self.n_layers % len(self.pattern)

    def is_moe_layer(self, i: int) -> bool:
        return (self.moe_period > 0 and i >= self.moe_offset
                and (i - self.moe_offset) % self.moe_period == 0)

    @property
    def has_full_attention(self) -> bool:
        return any(k == "attn" for k in self.full_pattern)

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Exact parameter count."""
        d, hd = self.d_model, self.hd
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = self.padded_vocab * d  # embeddings
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        eff = self.expert_d_ff or self.d_ff
        for i, kind in enumerate(self.full_pattern):
            if kind in ("attn", "attn_local"):
                total += d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
                total += 2 * d  # norms
                if self.qk_norm:
                    total += 2 * hd
            elif kind == "mamba":
                di = self.ssm_expand * d
                total += 2 * d * di + di * self.ssm_conv + \
                    di * (2 * self.ssm_state + 1) + di + di * d + d
            elif kind == "mlstm":
                di = int(self.mlstm_proj_factor * d)
                total += 2 * d * di + di * d + 3 * di * di // 4 + 3 * di + d
            elif kind == "slstm":
                di = d
                total += 4 * d * di + 4 * di + d
                fh = int(self.slstm_proj_factor * d)
                total += 2 * d * fh + fh * d
            if kind in ("attn", "attn_local", "mamba"):
                if self.is_moe_layer(i):
                    total += self.n_experts * 3 * d * eff
                    total += d * self.n_experts  # router
                    total += self.n_shared_experts * 3 * d * eff
                elif self.d_ff > 0:
                    total += 3 * d * self.d_ff
                total += d  # ffn norm
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.moe_period == 0:
            return self.param_count()
        d = self.d_model
        eff = self.expert_d_ff or self.d_ff
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.is_moe_layer(i))
        inactive = n_moe_layers * (self.n_experts - self.experts_per_token) \
            * 3 * d * eff
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests (the JAX package's rule)."""
    changes = dict(
        n_layers=max(2, len(cfg.pattern)) if cfg.remainder_layers == 0
        else len(cfg.pattern) + cfg.remainder_layers,
        d_model=64,
        n_heads=max(2, min(cfg.n_heads, 4)),
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        window=32,
        n_experts=min(cfg.n_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        expert_d_ff=64 if cfg.n_experts else 0,
        ssm_state=8,
        mrope_sections=(2, 3, 3),  # sums to head_dim/2 = 8
    )
    if cfg.n_layers % len(cfg.pattern) == 0:
        changes["n_layers"] = len(cfg.pattern) * min(2, cfg.n_periods)
    return dataclasses.replace(cfg, **changes)
