"""Device microseconds of the mamba layers in the traced prefill (the ops
launched inside the port's ``repro_torch.mamba`` spans: in-projection,
convolution, ``mamba_scan``, gating and out-projection), over its prompt
tokens."""


def read(run):
    t, w = run.trace, run.traced_wave
    if t is None or w is None or w.traced[0] != 0:
        return None
    pre = t.marked("repro_torch.prefill")
    if not pre:
        return None
    lo, hi = pre[0][0].start, pre[0][0].end
    ops = [o for m, ops in t.marked("repro_torch.mamba")
           if lo <= m.start <= hi for o in ops]
    if not ops:
        return None
    return sum(o.dur for o in ops) / (run.batch * w.prompt_len)
