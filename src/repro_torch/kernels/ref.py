"""Plain PyTorch oracles for the port's kernels (materialized masks,
sequential recurrences).

``attention_ref`` is the plain version that both attention kernels are held
against, ``mamba_scan_ref`` that of ``mamba_scan`` and ``mlstm_ref`` that of
``mlstm_scan``: on the CPU ``ops`` uses them, and ``chip_smoke.py`` compares
each CUDA kernel with them on the card.
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


def mamba_scan_ref(u, dt, a, b, c, h0):
    """Sequential selective scan, all fp32.  u,dt: (B,S,di)  a: (di,N)
    b,c: (B,S,N)  h0: (B,di,N)  ->  y (B,S,di) fp32, h_last (B,di,N).

    h_t = exp(dt_t·a) ⊙ h_{t-1} + (dt_t·b_t)·u_t,   y_t = h_t · c_t.
    """
    u, dt, b, c = (t.float() for t in (u, dt, b, c))
    a = a.float()
    h = h0.float()
    ys = []
    for t in range(u.shape[1]):
        dt_t = dt[:, t, :, None]                                # (B,di,1)
        h = torch.exp(dt_t * a) * h + dt_t * b[:, t, None, :] * \
            u[:, t, :, None]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1), h


def mlstm_ref(q, k, v, i_gate, f_gate, c0, n0):
    """Sequential mLSTM (gated linear attention form used by the model).

    q,k,v: (B,S,H,hd)  i,f: (B,S,H) in (0,1)  c0: (B,H,hd,hd)  n0: (B,H,hd)
    y_t = q_t · C_t  with  C_t = f_t C_{t-1} + i_t k_t v_tᵀ  (all fp32).
    Returns (y (B,S,H,hd) fp32, c_last, n_last).
    """
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    q, k, v, i_gate, f_gate = (t.float() for t in (q, k, v, i_gate, f_gate))
    C, n = c0.float(), n0.float()
    ys = []
    for t in range(q.shape[1]):
        q_t, k_t, v_t = q[:, t], k[:, t], v[:, t]               # (B,H,hd)
        i_t, f_t = i_gate[:, t], f_gate[:, t]                   # (B,H)
        C = f_t[..., None, None] * C + \
            i_t[..., None, None] * torch.einsum("bhd,bhe->bhde", k_t, v_t)
        n = f_t[..., None] * n + i_t[..., None] * k_t
        ys.append(torch.einsum("bhd,bhde->bhe", q_t * scale, C))
    return torch.stack(ys, dim=1), C, n
