"""The traced prefill's ``mamba_scan`` calls: the sum of their bounds
(``counts/mamba_scan``) over their device time, in %.  One call a mamba
layer over the prompt, fp32 inputs."""
from perfbench import registry


def read(run):
    serve = registry.module("metrics", "_serve")
    span = serve.prefill(run)
    if span is None:
        return None
    ms = registry.module("counts", "mamba_scan")
    d, B, S = run.plan.dims, run.batch, run.traced_wave.prompt_len
    calls = sum(m == "mamba" for m, _ in run.plan.layers)
    ks = serve.kernels_between(run, ms.KERNEL, *span)
    if not calls or len(ks) != calls:
        return None
    bound = calls * ms.bound(B, S, d["expand"] * d["d"], d["d_state"])[0]
    return 100.0 * bound / (sum(k.dur for k in ks) / 1e3)
