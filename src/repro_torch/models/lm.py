"""Decoder LM: embeddings → layer loop → head (port of ``repro.models.lm``).

``LM`` is an ``nn.Module`` whose ``layers`` hold one ``ParamTree`` per
layer: ``mixer`` and ``ffn`` subtrees whose parameters are named and nested
as the JAX leaves (an MoE FFN holds ``ffn/moe/router`` and the experts).
The JAX package's ``lax.scan`` over stacked periods becomes a plain loop.

Entry points, as in the JAX package:
  forward(batch, remat=...)      train-mode logits + masked shifted NLL
  prefill(batch, max_len)        last-position logits + the filled cache
  decode_step(batch, cache, pos) one token against the cache (in place)
A batch holds ``tokens``, ``frame_embeds`` or ``patch_embeds`` + ``tokens``
as ``cfg.input_mode`` says (``LM.embed_inputs``), and ``labels`` to train.

The parameters require grad.  ``forward`` records a graph when grad is
enabled; the kernels have no backward and refuse inputs that require grad,
so a training forward takes the plain path (``plain=True``), as the JAX
package differentiates its plain attention and scans.  ``prefill`` and
``decode_step`` run under ``torch.inference_mode()``: serving builds no
graph, and its in-place cache writes stay legal.

``LM(..., rules=)`` holds DTensor parameters placed by the rules (the
port's counterpart of the JAX package's parameters under its
``NamedSharding``s); the same entry points then run as the JAX package's
steps do under ``use_rules``: the batch, positions and labels join the
mesh (``sharding.place``), the activations are constrained where the JAX
package's are, and the prefill's cache is placed by the cache specs (the
recurrent states, fp32, too).  Every layer kind runs so: attention, dense
and MoE FFNs (each MoE layer's aux loss is a replicated DTensor scalar,
summed over the layers into the loss), mamba, mLSTM and sLSTM, under any
``remat``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import obs
from ..device import resolve
from ..launch.sharding import (Rules, constrain, current_rules, frozen,
                               from_local, is_dtensor, place, shard_offsets)
from .blocks import ATTN_KINDS, Ctx, layer_apply, layer_specs, mixer
from .config import ModelConfig
from .layers import PSpec, dense, init_tensor, mrope_cos_sin, \
    mrope_positions, rms_norm, rope_cos_sin, rows_product, softcap, \
    stack_specs, struct, text_positions


class ParamTree(nn.Module):
    """Parameters nested as a spec dict is: a ``PSpec`` becomes a parameter,
    a dict a subtree.  ``tree[name]`` reads either, ``name in tree`` asks.
    With ``rules``, each parameter is a DTensor placed by them."""

    def __init__(self, specs: Dict[str, Any], dtype, device,
                 rules: Optional[Rules] = None) -> None:
        super().__init__()
        for name, s in specs.items():
            if isinstance(s, PSpec):
                self.register_parameter(name, _parameter(s, dtype, device,
                                                         rules))
            else:
                self.add_module(name, ParamTree(s, dtype, device, rules))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _parameter(spec: PSpec, dtype, device, rules: Optional[Rules]):
    if rules is None:
        return nn.Parameter(torch.empty(spec.shape, dtype=dtype,
                                        device=device))
    return nn.Parameter(struct(spec.shape, dtype, rules, spec.axes,
                               device=device))


def _leaves(tree: ParamTree, specs: Dict[str, Any]):
    """(parameter, PSpec) pairs of a subtree, depth first, in spec order."""
    for name, s in specs.items():
        if isinstance(s, PSpec):
            yield tree[name], s
        else:
            yield from _leaves(tree[name], s)


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Top-level specs plus one spec dict per layer (not stacked)."""
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": PSpec((cfg.padded_vocab, d), ("model", "fsdp"), scale=0.02),
        "final_ln": PSpec((d,), (None,), init="zeros"),
        "layers": [layer_specs(cfg, i) for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = PSpec((d, cfg.padded_vocab), ("fsdp", "model"))
    if cfg.input_mode in ("embeds", "mixed"):
        specs["frontend_proj"] = PSpec((d, d), ("fsdp", "model"))
    return specs


class LM(nn.Module):
    """Parameters of one model; tensors are allocated, not initialized (see
    ``init_model`` and ``convert.params_from_numpy``).  With ``rules``,
    DTensors over ``rules.mesh``, each placed as its spec's axes say."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 device="cuda", rules: Optional[Rules] = None) -> None:
        super().__init__()
        dev = resolve(device)
        self.cfg = cfg
        self.specs = model_specs(cfg)
        for name, s in self.specs.items():
            if name != "layers":
                self.register_parameter(name, _parameter(s, dtype, dev,
                                                         rules))
        self.layers = nn.ModuleList(ParamTree(layer, dtype, dev, rules)
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
        """The stub frontends of ``cfg.input_mode``: "tokens" looks up
        ``tokens``; "embeds" projects ``frame_embeds`` (B, S, d); "mixed"
        puts the projected ``patch_embeds`` (B, P, d) before the embedded
        ``tokens``.  The embeddings are cast to the table's dtype before
        the projection, as in the JAX package."""
        mode = self.cfg.input_mode
        emb = self.embed
        with obs.span("embed"):
            batch = {k: place(t, ("batch",) + (None,) * (t.ndim - 1), emb)
                     for k, t in batch.items()}
            if mode == "tokens":
                x = _lookup(emb, batch["tokens"])
            elif mode == "embeds":
                x = dense(batch["frame_embeds"].to(emb.dtype),
                          self.frontend_proj)
            else:
                x = _lookup(emb, batch["tokens"])
                if batch["patch_embeds"].shape[1]:      # none in decode
                    patches = dense(batch["patch_embeds"].to(emb.dtype),
                                    self.frontend_proj)
                    x = torch.cat([patches, x], dim=1)
            x = x * torch.tensor(self.cfg.embed_scale, dtype=x.dtype)
            return constrain(x, ("batch", None, None))

    def positions(self, batch: Dict[str, torch.Tensor], B: int,
                  S: int) -> torch.Tensor:
        """Positions of a prompt of S embedded inputs (the JAX package's
        ``_positions``): under M-RoPE the (3, B, S) stub layout, in which
        the ``tokens`` are the text and the rest are patches; else 0..S-1."""
        device = self.embed.device
        if self.cfg.mrope:
            n_text = batch["tokens"].shape[1] if "tokens" in batch else 0
            return place(mrope_positions(B, S - n_text, n_text,
                                         device=device),
                         (None, "batch", None), self.embed)
        return place(text_positions(B, S, device=device), ("batch", None),
                     self.embed)

    def rope(self, positions) -> Dict[float, Any]:
        """``rope_tables`` of this model."""
        return rope_tables(self.cfg, positions)

    def layer_ctx(self, kind: str, ropes, **kw) -> Ctx:
        """``layer_ctx`` of this model."""
        return layer_ctx(self.cfg, kind, ropes, **kw)

    def run_layers(self, x, *, mode: str, positions, cache=None,
                   pos_offset: int = 0, max_len: int = 0,
                   remat: str = "none", plain: Optional[bool] = None):
        """``run_layers`` over this model's layers; ``plain`` overrides
        ``plain_kernels``."""
        return run_layers(self.cfg, self.layers, x, mode=mode,
                          positions=positions, cache=cache,
                          pos_offset=pos_offset, max_len=max_len,
                          remat=remat,
                          plain=self.plain_kernels if plain is None
                          else plain)

    def _head(self, x):
        cfg = self.cfg
        with obs.span("head"):
            x = rms_norm(x, self.final_ln, cfg.norm_eps)
            if cfg.tie_embeddings:
                # Not ``x @ embed.t()``: a view of a DTensor parameter fails
                # under inference_mode.
                logits = rows_product(torch.nn.functional.linear, x,
                                      frozen(self.embed))
            else:
                logits = dense(x, self.unembed)
            logits = logits / torch.tensor(cfg.logit_divisor,
                                           dtype=logits.dtype)
            return constrain(softcap(logits, cfg.final_softcap),
                             ("batch", None, "model"))

    # -- entry points ---------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor], *, remat: str = "none",
                plain: Optional[bool] = None):
        """Train mode: next-token cross-entropy over the whole sequence.
        Returns (loss, logits).  ``remat`` is "none", "dots" or "full"
        (``_remat_wrap``); ``plain=True`` takes the plain path whatever
        ``plain_kernels`` says (training does)."""
        cfg = self.cfg
        with obs.step("forward", **_step_attrs(batch, 0)):
            x = self.embed_inputs(batch)
            B, S, _ = x.shape
            positions = self.positions(batch, B, S)
            x, aux = self.run_layers(x, mode="train", positions=positions,
                                     remat=remat, plain=plain)
            logits = self._head(x)
            # Shift: predict token t+1 at position t; ignore label < 0.
            lg = logits[:, :-1].float()
            lb = place(batch["labels"], ("batch", None), logits)[:, 1:].long()
            mask = (lb >= 0).float()
            logz, gold = _nll_terms(lg, lb)
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
        with obs.step("prefill", **_step_attrs(batch, 0)):
            x = self.embed_inputs(batch)
            B, S, _ = x.shape
            cache = init_cache(self.cfg, B, max_len, dtype=x.dtype,
                               device=x.device,
                               rules=_rules_of(x))
            positions = self.positions(batch, B, S)
            x, _ = self.run_layers(x, mode="prefill", positions=positions,
                                   cache=cache, max_len=max_len)
            return self._head(x[:, -1:]), cache, S

    @torch.inference_mode()
    def decode_step(self, batch: Dict[str, torch.Tensor], cache, pos: int):
        """One decode step at absolute position ``pos``; the cache is written
        in place and returned."""
        with obs.step("decode_step", **_step_attrs(batch, pos)):
            x = self.embed_inputs(batch)
            B, S, _ = x.shape
            shape = (3, B, S) if self.cfg.mrope else (B, S)
            positions = place(torch.full(shape, int(pos), dtype=torch.int32,
                                         device=x.device),
                              ((None,) if self.cfg.mrope else ()) +
                              ("batch", None), x)
            x, _ = self.run_layers(x, mode="decode", positions=positions,
                                   cache=cache, pos_offset=int(pos))
            return self._head(x), cache


def _step_attrs(batch: Dict[str, torch.Tensor], pos) -> Dict[str, int]:
    """An entry point's span attributes: the batch, the inputs it embeds
    (patches and tokens, or frames) and the absolute position."""
    lead = [t.shape for k, t in batch.items() if k != "labels"]
    return {"B": lead[0][0], "S": sum(s[1] for s in lead), "pos": int(pos)}


def _lookup(emb, tokens):
    """``emb[tokens]``.  On DTensors, on each rank's shards: the table at
    its use-time placement ("model", None), so only its vocabulary stays
    cut; a rank looks up the tokens of its own rows and zeros the others,
    and the partial sums over the vocab shards are reduced by the
    ``constrain`` that follows (the vocab-parallel embedding)."""
    if not is_dtensor(emb):
        return emb[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    emb = constrain(emb, ("model", None))
    mesh = emb.device_mesh
    # Per mesh dim: (the tokens' placement, the output's, the table's
    # gradient's).
    plan = []
    for e, t in zip(emb.placements, tokens.placements):
        if e == Shard(0):                     # a block of the vocabulary
            plan.append((Replicate(), Partial(), e))
        elif e == Shard(1):                   # a block of d_model
            plan.append((Replicate(), Shard(2), e))
        else:                                 # whole: the tokens' cut
            plan.append((t, t, Partial() if isinstance(t, Shard) else e))
    tok_pl, out_pl, grad_pl = (list(x) for x in zip(*plan))
    tokens = tokens.redistribute(mesh, tok_pl)
    v0 = shard_offsets(emb)[0]
    local = emb.to_local(grad_placements=grad_pl)
    ids = tokens.to_local().long() - v0
    mine = (ids >= 0) & (ids < local.shape[0])
    x = local[ids.clamp(0, max(local.shape[0] - 1, 0))] * mine[..., None]
    return from_local(x, mesh, out_pl, tuple(tokens.shape) + (emb.shape[1],))


def _nll_terms(lg, lb):
    """(logsumexp, gold logit) of the logits ``lg`` over their last dim at
    the labels ``lb`` (>= 0).  DTensor logits whose vocabulary is cut over
    several ranks take the max, exp and sum of ``torch.logsumexp`` spelled
    out and the gold logit picked by an iota compare and a sum (the JAX
    package's form), so that only (B, S) partials are reduced across the
    vocab shards, never the logits gathered.  Other DTensor logits take,
    on each rank's shard, what a plain tensor takes: ``torch.logsumexp``
    and ``gather`` (one rank's step is then the plain step's, bit for
    bit)."""
    if not is_dtensor(lg):
        return (torch.logsumexp(lg, dim=-1),
                lg.gather(-1, lb.clamp_min(0)[..., None])[..., 0])
    from torch.distributed.tensor import Replicate, Shard
    mesh = lg.device_mesh
    if any(p == Shard(2) and mesh.size(d) > 1
           for d, p in enumerate(lg.placements)):
        m = lg.detach().amax(dim=-1, keepdim=True)
        logz = (lg - m).exp().sum(dim=-1).log() + m[..., 0]
        iota = place(torch.arange(lg.shape[-1], device=lg.device), (None,),
                     lg)
        gold = torch.where(iota == lb[..., None], lg, 0.0).sum(dim=-1)
        return logz, gold
    rows = [p if isinstance(p, Shard) and p.dim < 2 else Replicate()
            for p in lg.placements]
    lg = lg.redistribute(mesh, rows)
    logz, gold = _nll_terms(lg.to_local(grad_placements=rows),
                            lb.redistribute(mesh, rows).to_local())
    return (from_local(logz, mesh, rows, lb.shape),
            from_local(gold, mesh, rows, lb.shape))


def _rules_of(x) -> Optional[Rules]:
    """The active rules, which a model of DTensors runs under (its cache is
    placed by them); None for a plain tensor."""
    if not is_dtensor(x):
        return None
    rules = current_rules()
    if rules is None:
        raise RuntimeError("a model of DTensors runs under its rules "
                           "(launch.sharding.use_rules, as the steps do)")
    return rules


def run_layers(cfg: ModelConfig, layers, x, *, mode: str, positions,
               cache=None, pos_offset: int = 0, max_len: int = 0,
               remat: str = "none", plain: bool = False):
    """Apply every layer of ``cfg.full_pattern``, ``layers[li]`` holding
    layer li's parameters (a ``ParamTree`` or a dict of the same nesting);
    writes the cache (``init_cache``'s layout) in place.  Returns (x,
    aux).  ``remat`` recomputes each layer in the backward
    (``_remat_wrap``)."""
    aux_total = 0.0
    ropes = rope_tables(cfg, positions)
    for li, kind in enumerate(cfg.full_pattern):
        ctx = layer_ctx(
            cfg, kind, ropes, mode=mode,
            cache=None if cache is None else layer_cache(cfg, cache, li),
            pos_offset=pos_offset, max_len=max_len, plain=plain)

        def layer(h, li=li, kind=kind, ctx=ctx):
            h, _, a = layer_apply(cfg, kind, layer_is_moe(cfg, li),
                                  layers[li], h, ctx, layer=li)
            return h, a

        x, a = _remat_wrap(layer, remat)(x)
        aux_total = aux_total + a
    return x, aux_total


# ---------------------------------------------------------------------------
# Rematerialization (the counterpart of the JAX package's ``lm._remat_wrap``)
# ---------------------------------------------------------------------------
# The matrix products, and the expert-parallel MoE's all-to-alls (so that
# recomputing a layer moves nothing).
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops._c10d_functional.all_to_all_single.default)


def _save_products(ctx, op, *args, **kwargs):
    """"dots": keep the ``_SAVED_PRODUCTS``' outputs, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, remat: str):
    """``fn`` recomputed in the backward: "full" saves only its inputs,
    "dots" also the ``aten.mm`` / ``aten.bmm`` outputs (the JAX package
    saves the dots without batch dims) and the all-to-alls', "none" is
    ``fn`` itself.  The JAX
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
               device="cuda", rules: Optional[Rules] = None) -> LM:
    """A model with the JAX package's per-leaf init distributions, drawn
    from a ``torch.Generator`` on ``device`` seeded with ``seed``.  With
    ``rules``, DTensor parameters holding the same numbers: each leaf is
    drawn whole, then cut to this rank's shard (``local_part``)."""
    dev = resolve(device)
    model = LM(cfg, dtype=dtype, device=dev, rules=rules)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        for param, spec in model.named_specs():
            if rules is None:
                init_tensor(spec, gen, dtype=dtype, device=dev, out=param)
            else:
                whole = init_tensor(spec, gen, dtype=dtype, device=dev)
                param.to_local().copy_(local_part(whole, param))
    return model


def local_part(whole: torch.Tensor, like) -> torch.Tensor:
    """The part of ``whole``, a tensor of the DTensor ``like``'s global
    shape, that this rank holds of ``like``."""
    local = like.to_local()
    out = whole
    for d, (o, n) in enumerate(zip(shard_offsets(like), local.shape)):
        out = out.narrow(d, o, n)
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """The JAX cache tree: ``layers/p{p}/{k,v}`` stacked over periods, then
    ``rem{r}`` for the layers past the last whole period."""
    period = len(cfg.pattern)
    out: Dict[str, Any] = {}
    if cfg.n_periods > 0:
        out["layers"] = {
            f"p{p}": stack_specs(
                mixer(cfg.pattern[p])[2](cfg, batch, max_len), cfg.n_periods)
            for p in range(period)}
    for r in range(cfg.remainder_layers):
        kind = cfg.full_pattern[cfg.n_periods * period + r]
        out[f"rem{r}"] = mixer(kind)[2](cfg, batch, max_len)
    return out


def named_param_specs(cfg: ModelConfig) -> Dict[str, PSpec]:
    """{parameter name: PSpec} under the names ``LM.named_parameters``
    gives (``layers.{i}.mixer.wq``), without building the model."""
    out: Dict[str, PSpec] = {}

    def walk(prefix: str, tree):
        for name, s in tree.items():
            if isinstance(s, PSpec):
                out[prefix + name] = s
            else:
                walk(f"{prefix}{name}.", s)

    specs = model_specs(cfg)
    walk("", {k: v for k, v in specs.items() if k != "layers"})
    for i, layer in enumerate(specs["layers"]):
        walk(f"layers.{i}.", layer)
    return out


def rope_tables(cfg: ModelConfig, positions) -> Dict[float, Any]:
    """{theta: rope tables of ``positions``}, one entry per theta that the
    attention layers use (``kind_theta_window``); empty when the model has
    no attention (only attention layers rotate).  Under M-RoPE the tables
    are ``mrope_cos_sin``'s of the (3, B, S) positions."""
    thetas = {kind_theta_window(cfg, k)[0] for k in cfg.pattern
              if k in ATTN_KINDS}
    if cfg.mrope:
        return {th: mrope_cos_sin(positions, cfg.hd, th, cfg.mrope_sections)
                for th in sorted(thetas)}
    return {th: rope_cos_sin(positions, cfg.hd, th) for th in sorted(thetas)}


def layer_ctx(cfg: ModelConfig, kind: str, ropes, **kw) -> Ctx:
    """The ``Ctx`` of a layer of ``kind`` (the JAX package's
    ``_layer_ctx``): its window and the rope tables of its theta from
    ``ropes`` (``rope_tables``); ``kw`` are the other ``Ctx`` fields."""
    theta, window = kind_theta_window(cfg, kind)
    return Ctx(rope=ropes.get(theta), window=window, **kw)


def kind_theta_window(cfg: ModelConfig, kind: str):
    """(rope theta, window) of a layer of ``kind``: a local attention layer
    attends within ``cfg.window`` and rotates at ``local_rope_theta`` when
    it is set; every other layer is global at ``rope_theta``."""
    if kind == "attn_local":
        theta = cfg.rope_theta if cfg.local_rope_theta is None \
            else cfg.local_rope_theta
        return theta, cfg.window
    return cfg.rope_theta, 0


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
        return {n: _row(t, i) for n, t in cache["layers"][f"p{p}"].items()}
    return cache[f"rem{li - cfg.n_periods * period}"]


def _row(t, i: int):
    """``t[i]``, a view.  For a DTensor (whose stacked dim 0 is never cut),
    the view is taken on the local shard and wrapped: DTensor's own view
    of a cache made outside ``inference_mode`` fails inside it."""
    if not is_dtensor(t):
        return t[i]
    from torch.distributed.tensor import Shard
    placements = [Shard(q.dim - 1) if isinstance(q, Shard) else q
                  for q in t.placements]
    return from_local(t.to_local()[i], t.device_mesh, placements,
                      t.shape[1:])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda",
               rules: Optional[Rules] = None):
    """Zeroed cache tensors; a leaf whose spec pins a dtype (the recurrent
    states, fp32) keeps it, the others take ``dtype``.  With ``rules``,
    DTensors placed by the cache specs' axes."""
    dev = resolve(device)

    def build(tree):
        if isinstance(tree, PSpec):
            return struct(tree.shape, tree.dtype or dtype, rules, tree.axes,
                          device=dev)
        return {k: build(v) for k, v in tree.items()}

    return build(cache_specs(cfg, batch, max_len))
