"""The traced decode steps' ``flash_decode`` calls: the sum of their
bounds (``counts/flash_decode``, each at its step's key count) over their
device time, in %.  One call an attention layer a step."""
from perfbench import registry


def read(run):
    serve = registry.module("metrics", "_serve")
    steps = serve.decode_steps(run)
    layers = sum(m == "attention" for m, _ in run.plan.layers)
    if not steps or not layers:
        return None
    fd = registry.module("counts", "flash_decode")
    d, B, S = run.plan.dims, run.batch, run.traced_wave.prompt_len
    T = S + run.traced_wave.new_tokens
    ks = serve.kernels_between(run, fd.KERNEL, steps[0][1], steps[-1][2])
    if len(ks) != layers * len(steps):
        return None
    bound = layers * sum(fd.bound(B, d["heads"], d["kv_heads"], T, d["hd"],
                                  S + i)[0] for i, _, _ in steps)
    return 100.0 * bound / (sum(k.dur for k in ks) / 1e3)
