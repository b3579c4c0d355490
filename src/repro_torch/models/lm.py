"""Decoder LM: embeddings → layer loop → head (port of ``repro.models.lm``).

``LM`` is an ``nn.Module`` whose ``layers`` hold one ``ParamTree`` per
layer: ``mixer`` and ``ffn`` subtrees whose parameters are named and nested
as the JAX leaves (an MoE FFN holds ``ffn/moe/router`` and the experts).
The JAX package's ``lax.scan`` over stacked periods becomes a plain loop.

Entry points, as in the JAX package:
  forward(batch, remat=...)      train-mode logits + masked shifted NLL
  prefill(batch, max_len)        last-position logits + the filled cache
  decode_step(batch, cache, pos) one token against the cache (in place)

The parameters require grad.  ``forward`` records a graph when grad is
enabled; the kernels have no backward and refuse inputs that require grad,
so a training forward takes the plain path (``plain=True``), as the JAX
package differentiates its plain attention and scans.  ``prefill`` and
``decode_step`` run under ``torch.inference_mode()``: serving builds no
graph, and its in-place cache writes stay legal.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve
from .blocks import ATTN_KINDS, Ctx, layer_apply, layer_specs, mixer, \
    not_ported
from .config import ModelConfig
from .layers import PSpec, dense, init_tensor, rms_norm, rope_cos_sin, \
    softcap, text_positions


class ParamTree(nn.Module):
    """Parameters nested as a spec dict is: a ``PSpec`` becomes a parameter,
    a dict a subtree.  ``tree[name]`` reads either, ``name in tree`` asks."""

    def __init__(self, specs: Dict[str, Any], dtype, device) -> None:
        super().__init__()
        for name, s in specs.items():
            if isinstance(s, PSpec):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(s.shape, dtype=dtype, device=device)))
            else:
                self.add_module(name, ParamTree(s, dtype, device))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _leaves(tree: ParamTree, specs: Dict[str, Any]):
    """(parameter, PSpec) pairs of a subtree, depth first, in spec order."""
    for name, s in specs.items():
        if isinstance(s, PSpec):
            yield tree[name], s
        else:
            yield from _leaves(tree[name], s)


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Top-level specs plus one spec dict per layer (not stacked)."""
    if cfg.input_mode != "tokens":
        raise not_ported("mrope")
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": PSpec((cfg.padded_vocab, d), scale=0.02),
        "final_ln": PSpec((d,), init="zeros"),
        "layers": [layer_specs(cfg, i) for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = PSpec((d, cfg.padded_vocab))
    return specs


class LM(nn.Module):
    """Parameters of one model; tensors are allocated, not initialized (see
    ``init_model`` and ``convert.params_from_numpy``)."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 device="cuda") -> None:
        super().__init__()
        dev = resolve(device)
        self.cfg = cfg
        self.specs = model_specs(cfg)
        for name, s in self.specs.items():
            if name != "layers":
                self.register_parameter(name, nn.Parameter(
                    torch.empty(s.shape, dtype=dtype, device=dev)))
        self.layers = nn.ModuleList(ParamTree(layer, dtype, dev)
                                    for layer in self.specs["layers"])
        # The plain PyTorch versions (attention, the chunked selective scan,
        # the chunkwise mLSTM cell) instead of the kernels: the reference
        # that chip_smoke.py holds the kernel path against on the card.
        self.plain_kernels = False

    def named_specs(self):
        """(parameter, PSpec) pairs in a fixed order."""
        for name, s in self.specs.items():
            if name != "layers":
                yield getattr(self, name), s
        for layer, layer_spec in zip(self.layers, self.specs["layers"]):
            yield from _leaves(layer, layer_spec)

    # -- pieces -------------------------------------------------------------
    def embed_inputs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = self.embed[batch["tokens"]]
        return x * torch.tensor(self.cfg.embed_scale, dtype=x.dtype)

    def rope(self, positions):
        """The rope tables of ``positions`` for the attention layers; None
        when the model has none (only attention layers rotate)."""
        cfg = self.cfg
        if any(k in ATTN_KINDS for k in cfg.pattern):
            return rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
        return None

    def run_layers(self, x, *, mode: str, positions, cache=None,
                   pos_offset: int = 0, max_len: int = 0,
                   remat: str = "none", plain: Optional[bool] = None):
        """Apply every layer; writes the cache in place.  Returns (x, aux).
        ``plain`` overrides ``plain_kernels``; ``remat`` recomputes each
        layer in the backward (``_remat_wrap``)."""
        cfg = self.cfg
        aux_total = 0.0
        rope = self.rope(positions)
        for li, kind in enumerate(cfg.full_pattern):
            ctx = Ctx(mode=mode, rope=rope,
                      cache=None if cache is None else layer_cache(
                          cfg, cache, li),
                      pos_offset=pos_offset, max_len=max_len,
                      plain=self.plain_kernels if plain is None else plain)

            def layer(h, li=li, kind=kind, ctx=ctx):
                h, _, a = layer_apply(cfg, kind, layer_is_moe(cfg, li),
                                      self.layers[li], h, ctx)
                return h, a

            x, a = _remat_wrap(layer, remat)(x)
            aux_total = aux_total + a
        return x, aux_total

    def _head(self, x):
        cfg = self.cfg
        x = rms_norm(x, self.final_ln, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = torch.matmul(x, self.embed.t())
        else:
            logits = dense(x, self.unembed)
        logits = logits / torch.tensor(cfg.logit_divisor, dtype=logits.dtype)
        return softcap(logits, cfg.final_softcap)

    # -- entry points ---------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor], *, remat: str = "none",
                plain: Optional[bool] = None):
        """Train mode: next-token cross-entropy over the whole sequence.
        Returns (loss, logits).  ``remat`` is "none", "dots" or "full"
        (``_remat_wrap``); ``plain=True`` takes the plain path whatever
        ``plain_kernels`` says (training does)."""
        cfg = self.cfg
        x = self.embed_inputs(batch)
        B, S, _ = x.shape
        positions = text_positions(B, S, device=x.device)
        x, aux = self.run_layers(x, mode="train", positions=positions,
                                 remat=remat, plain=plain)
        logits = self._head(x)
        # Shift: predict token t+1 at position t; ignore label < 0.
        lg = logits[:, :-1].float()
        lb = batch["labels"][:, 1:].long()
        mask = (lb >= 0).float()
        logz = torch.logsumexp(lg, dim=-1)
        gold = lg.gather(-1, lb.clamp_min(0)[..., None])[..., 0]
        nll = (logz - gold) * mask
        loss = nll.sum() / mask.sum().clamp_min(1.0)
        if isinstance(aux, torch.Tensor) or aux:
            loss = loss + cfg.router_aux_coef * aux / max(1, cfg.n_layers)
        return loss, logits

    @torch.inference_mode()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int):
        """Process the prompt; return (last-position logits, cache, next_pos).
        The cache is ``init_cache`` in the activations' dtype (recurrent
        states in fp32), filled up to the prompt length and zero past it."""
        x = self.embed_inputs(batch)
        B, S, _ = x.shape
        cache = init_cache(self.cfg, B, max_len, dtype=x.dtype,
                           device=x.device)
        positions = text_positions(B, S, device=x.device)
        x, _ = self.run_layers(x, mode="prefill", positions=positions,
                               cache=cache, max_len=max_len)
        return self._head(x[:, -1:]), cache, S

    @torch.inference_mode()
    def decode_step(self, batch: Dict[str, torch.Tensor], cache, pos: int):
        """One decode step at absolute position ``pos``; the cache is written
        in place and returned."""
        x = self.embed_inputs(batch)
        B, S, _ = x.shape
        positions = torch.full((B, S), int(pos), dtype=torch.int32,
                               device=x.device)
        x, _ = self.run_layers(x, mode="decode", positions=positions,
                               cache=cache, pos_offset=int(pos))
        return self._head(x), cache


# ---------------------------------------------------------------------------
# Rematerialization (the counterpart of the JAX package's ``lm._remat_wrap``)
# ---------------------------------------------------------------------------
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _save_products(ctx, op, *args, **kwargs):
    """"dots": keep the matrix products' outputs, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, remat: str):
    """``fn`` recomputed in the backward: "full" saves only its inputs,
    "dots" also the ``aten.mm`` / ``aten.bmm`` outputs (the JAX package
    saves the dots without batch dims), "none" is ``fn`` itself.  The JAX
    package wraps one scanned period; the port wraps each layer."""
    if remat == "none":
        return fn
    if remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if remat == "dots":
        return lambda *a: checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(
                _save_products))
    raise ValueError(f"unknown remat {remat!r}: none, dots or full")


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------
def init_model(cfg: ModelConfig, seed: int = 0, *, dtype=torch.float32,
               device="cuda") -> LM:
    """A model with the JAX package's per-leaf init distributions, drawn
    from a ``torch.Generator`` on ``device`` seeded with ``seed``."""
    dev = resolve(device)
    model = LM(cfg, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        for param, spec in model.named_specs():
            param.copy_(init_tensor(spec, gen, dtype=dtype, device=dev))
    return model


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """The JAX cache tree: ``layers/p{p}/{k,v}`` stacked over periods, then
    ``rem{r}`` for the layers past the last whole period."""
    period = len(cfg.pattern)
    out: Dict[str, Any] = {}
    if cfg.n_periods > 0:
        out["layers"] = {
            f"p{p}": {n: dataclasses.replace(s, shape=(cfg.n_periods,)
                                             + s.shape)
                      for n, s in mixer(cfg.pattern[p])[2](
                          cfg, batch, max_len).items()}
            for p in range(period)}
    for r in range(cfg.remainder_layers):
        kind = cfg.full_pattern[cfg.n_periods * period + r]
        out[f"rem{r}"] = mixer(kind)[2](cfg, batch, max_len)
    return out


def layer_is_moe(cfg: ModelConfig, li: int) -> bool:
    """Whether layer ``li``'s FFN is an MoE.  As the JAX scan body does, a
    layer inside the periods takes the placement of its pattern position."""
    period = len(cfg.pattern)
    in_periods = li < cfg.n_periods * period
    return cfg.is_moe_layer(li % period if in_periods else li)


def layer_cache(cfg: ModelConfig, cache, li: int) -> Dict[str, Any]:
    """Layer ``li``'s cache: views ``t[i]`` of the tensors stacked over
    periods, or the ``rem{r}`` dict.  Written in place by the layer."""
    period = len(cfg.pattern)
    i, p = divmod(li, period)
    if i < cfg.n_periods:
        return {n: t[i] for n, t in cache["layers"][f"p{p}"].items()}
    return cache[f"rem{li - cfg.n_periods * period}"]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda"):
    """Zeroed cache tensors; a leaf whose spec pins a dtype (the recurrent
    states, fp32) keeps it, the others take ``dtype``."""
    dev = resolve(device)

    def build(tree):
        if isinstance(tree, PSpec):
            return torch.zeros(tree.shape, dtype=tree.dtype or dtype,
                               device=dev)
        return {k: build(v) for k, v in tree.items()}

    return build(cache_specs(cfg, batch, max_len))
