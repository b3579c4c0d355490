"""Device microseconds of the MoE layers' work around the expert products
in the traced prefill: the ops launched inside the port's
``repro_torch.moe`` spans less those inside ``repro_torch.moe.experts``
and ``repro_torch.obs`` (the router, top-k, sort, scatter into the
capacity buffers, gather and weighted sum), over its prompt tokens."""


def read(run):
    t, w = run.trace, run.traced_wave
    if t is None or w is None or w.traced[0] != 0:
        return None
    pre = t.marked("repro_torch.prefill")
    if not pre:
        return None
    lo, hi = pre[0][0].start, pre[0][0].end
    ops = [o for m, ops in t.marked("repro_torch.moe")
           if lo <= m.start <= hi for o in ops]
    if not ops:
        return None
    skip = {id(o) for name in ("repro_torch.moe.experts", "repro_torch.obs")
            for _, inner in t.marked(name) for o in inner}
    glue = sum(o.dur for o in ops if id(o) not in skip)
    return glue / (run.batch * w.prompt_len)
