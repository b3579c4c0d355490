"""What decides ``correct``: the reference's view of the tokens the
window served.

After the window, a sample of the waves it finished, drawn from the seed
with the longest prompt always in it, is run through the reference
(``reference/decoder``) over each request's prompt and served tokens.
A served token's gap is how far its logit lies below the reference's best
at that position; the numbers compared (``limits/<cell>.json``) are read
from these gaps.  A model whose
layers couple the requests of a wave (the MoE's capacity is shared by
every token of a step) is checked on whole waves.

The control is the reference itself in the precision below the
configuration's (``float8``): at each position the token it puts first,
read by the float32 reference's gap.  ``calibrate.py`` reads both."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference import decoder


def coupled(plan) -> bool:
    return any(f == "moe" for _, f in plan.layers)


def sample(waves, traffic: dict, seed: int, plan) -> List[Tuple[object,
                                                               np.ndarray]]:
    """[(wave, request indices)] to check."""
    done = [w for w in waves if w.tokens is not None]
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % 2 ** 64, 2])
    longest = max(done, key=lambda w: w.prompt_len)
    rest = [w for w in done if w is not longest]
    n = min(len(done), traffic["check"]["waves"])
    picked = [longest] + [rest[i] for i in sorted(
        rng.choice(len(rest), n - 1, replace=False))] if n > 1 else [longest]
    per = traffic["check"].get("requests_per_wave")
    B = traffic["batch"]
    out = []
    for w in picked:
        if per is None or coupled(plan) or per >= B:
            out.append((w, np.arange(B)))
        else:
            out.append((w, np.sort(rng.choice(B, per, replace=False))))
    return out


@torch.no_grad()
def reference_logits(plan, seed: int, prompts: np.ndarray,
                     served: np.ndarray, device, precision="float32"):
    """prompts (R, S), served (n, R) -> the reference's logits (R, n, V)
    at the positions where each served token was chosen."""
    S = prompts.shape[1]
    seq = np.concatenate([prompts, served[:-1].T], axis=1)
    tokens = torch.from_numpy(np.ascontiguousarray(seq)).to(device)
    return decoder.logits(plan, seed, tokens, S, precision)


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far the reference's logit of each chosen token lies below its
    best: ref (R, n, V), chosen (R, n) -> (R, n) fp32."""
    best = ref.max(dim=-1).values
    return best - ref.gather(-1, chosen[..., None].long())[..., 0]


def summary(parts) -> Dict[str, object]:
    """The numbers of the sample ``parts``: one (gaps (R, n), reference
    logits (R, n, V), chosen (R, n)) a wave.  ``worst_wave_mean_gap`` is
    the largest of the waves' mean gaps, so a fault confined to one wave
    (the longest cache, say) shows undiluted by the others;
    ``request_mean_gaps`` lists each wave's requests' means."""
    per = [g.double().mean(dim=1).cpu() for g, _, _ in parts]
    g = torch.cat([g.flatten() for g, _, _ in parts]).double().cpu()
    ref = torch.cat([r.reshape(-1, r.shape[-1]) for _, r, _ in parts])
    chosen = torch.cat([c.flatten() for _, _, c in parts])
    return {"max_gap": float(g.max()),
            "mean_gap": float(g.mean()),
            "p90_gap": float(torch.quantile(g, 0.9)),
            "worst_wave_mean_gap": max(float(m.mean()) for m in per),
            "mismatch_share": float((ref.argmax(-1) != chosen).double()
                                    .mean()),
            "tokens": int(g.numel()),
            "request_mean_gaps": [[round(float(x), 6) for x in m]
                                  for m in per]}


def compare(waves, traffic: dict, seed: int, plan, prompts_of, device,
            control: bool = False) -> Dict[str, Dict[str, object]]:
    """{"program": summary[, "control": summary]} over the sample.
    ``prompts_of(wave)`` gives a wave's prompts (B, S)."""
    got: Dict[str, List] = {"program": [], "control": []}
    for w, req in sample(waves, traffic, seed, plan):
        p, s = prompts_of(w)[req], w.tokens[:, req]
        ref = reference_logits(plan, seed, p, s, device)
        served = torch.from_numpy(np.ascontiguousarray(s.T)).to(ref.device)
        got["program"].append((gaps(ref, served), ref, served))
        if control:
            low = reference_logits(plan, seed, p, s, device, "float8")
            pick = low.argmax(dim=-1)
            got["control"].append((gaps(ref, pick), ref, pick))
            del low
    return {k: summary(parts) for k, parts in got.items() if parts}


def judged(reading: Dict[str, object], limits: dict) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}) for each limited number; a
    run with nothing checked (no wave finished) is not correct."""
    out, ok = {}, True
    for name, lim in limits["compare"].items():
        v = reading.get(name) if reading else None
        out[name] = {"value": v, "limit": lim}
        ok = ok and v is not None and v <= lim
    return ok, out


def readings_text(compared: Dict[str, Dict]) -> Sequence[str]:
    return [f"{k} {v['value']!r} limit {v['limit']!r}"
            for k, v in compared.items()]
