"""Plain PyTorch oracles for the port's kernels (materialized masks).

``attention_ref`` is the plain version that both attention kernels are held
against: on the CPU the kernel wrappers in ``ops`` use it, and
``chip_smoke.py`` compares each CUDA kernel with it on the card.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                  q_offset=0, kv_len=None):
    """q: (B,Hq,Sq,hd)  k,v: (B,Hkv,Skv,hd)  ->  (B,Hq,Sq,hd). fp32 math."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / math.sqrt(hd)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    keep = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        keep &= k_pos <= q_pos
        if window > 0:
            keep &= (q_pos - k_pos) < window
    if kv_len is not None:
        keep &= k_pos < kv_len
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
