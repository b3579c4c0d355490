"""The traced prefill's ``flash_attention`` calls: the sum of their bounds
(``counts/flash_attention``) over their device time, in %.  One call an
attention layer, causal over the prompt."""
from perfbench import registry


def read(run):
    serve = registry.module("metrics", "_serve")
    span = serve.prefill(run)
    if span is None:
        return None
    fa = registry.module("counts", "flash_attention")
    d, B, S = run.plan.dims, run.batch, run.traced_wave.prompt_len
    calls = sum(m == "attention" for m, _ in run.plan.layers)
    ks = serve.kernels_between(run, fa.KERNEL, *span)
    if not calls or len(ks) != calls:
        return None
    bound = calls * fa.bound(B, d["heads"], d["kv_heads"], S, S, d["hd"])[0]
    return 100.0 * bound / (sum(k.dur for k in ks) / 1e3)
