"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit)."""
HBM_BYTES_PER_S = 3.35e12
FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# The special-function units: 16 MUFU.EX2 per SM a clock, 132 SMs, at the
# 1.98 GHz behind the 67 TFLOP/s fp32 figure (128 lanes x 2 x 132 SMs).
SFU_EXPS_PER_S = 132 * 16 * 1.98e9


def least_ms(flops: float, nbytes: float, dtype: str = "bfloat16"):
    """(ms, what bounds it): the larger of the two times at the peaks."""
    t_ops = flops / FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
