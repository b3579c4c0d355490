"""Device microseconds of the expert products (the device ops launched by
``aten::bmm``, which on this path only ``moe._expert_ffn`` calls) in the
traced prefill, over its prompt tokens."""


def read(run):
    t, w = run.trace, run.traced_wave
    if t is None or w is None or w.traced[0] != 0:
        return None
    pre = t.marked("perfbench.prefill")
    if not pre:
        return None
    bmm = t.inside_host(pre[0][1], "aten::bmm")
    if not bmm:
        return None
    return sum(o.dur for o in bmm) / (run.batch * w.prompt_len)
