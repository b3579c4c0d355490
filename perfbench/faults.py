"""Faults planted under the served path, for the check to fail: each
takes the port's model and breaks it in place.

- ``cache_kept``: a decode step that leaves its state (the cache) as it
  was;
- ``half_batch``: half of the batch left out, its logits the mean of the
  rest;
- ``answer_altered``: an answer altered where it is produced (one
  request's logits negated).

The exchange between cards does not exist on one card.  The tests run
them at a small size on the CPU; ``calibrate.py --fault`` at a cell's own
size on the card."""
from __future__ import annotations


def cache_kept(model):
    step = model.decode_step

    def decode_step(batch, cache, pos):
        saved = {k: t.clone() for k, t in flat(cache).items()}
        logits, cache = step(batch, cache, pos)
        for k, t in flat(cache).items():
            t.copy_(saved[k])
        return logits, cache
    model.decode_step = decode_step


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def on_logits(model, change):
    prefill, step = model.prefill, model.decode_step

    def new_prefill(batch, max_len):
        logits, cache, pos = prefill(batch, max_len)
        return change(logits.clone()), cache, pos

    def new_step(batch, cache, pos):
        logits, cache = step(batch, cache, pos)
        return change(logits.clone()), cache
    model.prefill, model.decode_step = new_prefill, new_step


def half_batch(model):
    def change(logits):
        h = logits.shape[0] // 2
        logits[h:] = logits[:h].mean(dim=0, keepdim=True)
        return logits
    on_logits(model, change)


def answer_altered(model):
    def change(logits):
        logits[0] = -logits[0]
        return logits
    on_logits(model, change)


FAULTS = {"cache_kept": cache_kept, "half_batch": half_batch,
          "answer_altered": answer_altered}
