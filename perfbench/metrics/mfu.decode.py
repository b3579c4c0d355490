"""The traced decode steps' least time at the H100's published peaks over
their time on the device, in %: per step the larger of its model FLOPs
over 989 TFLOP/s and the bytes it must move once over 3.35 TB/s
(``counts/decode``)."""
from perfbench import registry


def read(run):
    serve = registry.module("metrics", "_serve")
    steps = serve.decode_steps(run)
    if not steps:
        return None
    decode = registry.module("counts", "decode")
    w, B = run.traced_wave, run.batch
    least = sum(decode.step(run.plan, B, w.prompt_len + i)[2]
                for i, _, _ in steps)
    took = (steps[-1][2] - steps[0][1]) / 1e3
    return 100.0 * least / took if took > 0 else None
