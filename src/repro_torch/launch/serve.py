"""Batched serving loop: prefill + decode with sampling (port of
``repro.launch.serve``).

A wave of prompts is prefilled once and decoded step by step (greedy, or
temperature with top-k), stopping on EOS or ``max_new_tokens``.  The KV
cache is written in place across steps.  Attention runs in the CUDA kernels
on the card: ``flash_attention`` for the prefill, ``flash_decode`` for each
decode step.  The JAX package's deprecated ``BatchServer`` is not ported;
``main`` drives ``generate`` wave by wave directly.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve
from ..models import config as mc
from ..models.lm import LM, init_model


@dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 => greedy
    top_k: int = 0                  # 0 => full softmax
    eos_id: Optional[int] = None
    max_len: int = 256
    seed: int = 0


def _sample(logits: torch.Tensor, scfg: ServeConfig,
            generator: torch.Generator) -> torch.Tensor:
    logits = logits[:, -1, :]
    if scfg.temperature <= 0:
        return logits.argmax(dim=-1)
    logits = logits.float() / scfg.temperature
    if scfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -scfg.top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(cfg: mc.ModelConfig, model: LM, prompts, scfg: ServeConfig, *,
             device="cuda") -> np.ndarray:
    """prompts: (B, S_prompt) ints — one wave.  Returns (B, new_tokens)
    int32.  ``model`` must live on ``device``.  Runs under
    ``torch.inference_mode()``: serving records no graph."""
    dev = resolve(device)
    if model.embed.device != dev:
        raise ValueError(f"model is on {model.embed.device}, not {dev}")
    prompts = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    B, S = prompts.shape
    if S + scfg.max_new_tokens > scfg.max_len:
        raise ValueError(f"prompt {S} + {scfg.max_new_tokens} new tokens "
                         f"exceed max_len {scfg.max_len}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(scfg.seed)

    logits, cache, _ = model.prefill({"tokens": prompts}, scfg.max_len)
    tok = _sample(logits[:, :, :cfg.vocab_size], scfg, gen)
    out = [tok]
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(1, scfg.max_new_tokens):
        if scfg.eos_id is not None:
            done = done | (tok == scfg.eos_id)
            if bool(done.all()):
                break
        logits, cache = model.decode_step({"tokens": tok[:, None]}, cache,
                                          S + t - 1)
        tok = _sample(logits[:, :, :cfg.vocab_size], scfg, gen)
        out.append(tok)
    return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import get_config
    cfg = mc.smoke(get_config(args.arch))
    model = init_model(cfg, 0, device=args.device)
    scfg = ServeConfig(max_new_tokens=args.max_new,
                       temperature=args.temperature, max_len=128)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (16,)).astype(np.int32)
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    tokens = waves = 0
    for i in range(0, len(prompts), args.batch):
        wave = prompts[i:i + args.batch]
        # pad the wave to a full batch by repeating the last request
        wave = wave + [wave[-1]] * (args.batch - len(wave))
        out = generate(cfg, model, np.stack(wave), scfg, device=args.device)
        tokens += out[:len(prompts[i:i + args.batch])].size
        waves += 1
    wall = time.perf_counter() - t0
    print(f"[serve] {len(prompts)} requests, {tokens} tokens, "
          f"{tokens / max(wall, 1e-9):.1f} tok/s over {waves} waves")
    return tokens


if __name__ == "__main__":
    main()
