"""The traced prefill's model FLOPs (``counts/prefill``) over its time on
the device times the bf16 peak of 989 TFLOP/s, in %."""
from perfbench import registry


def read(run):
    span = registry.module("metrics", "_serve").prefill(run)
    if span is None:
        return None
    peaks = registry.module("counts", "_peaks")
    flops = registry.module("counts", "prefill").model_flops(
        run.plan, run.batch, run.traced_wave.prompt_len)
    took = (span[1] - span[0]) / 1e6
    return 100.0 * flops / (took * peaks.FLOPS["bfloat16"])
