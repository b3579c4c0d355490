"""The least work of one ``mamba_scan`` call: the largest of three times.
Bytes: u, dt, b, c, a and h0 read once, y and h_last written once.
Operations: 8 a (token, channel, state) of the recurrence (dt a, its exp,
exp h, dt b, times u, the add, the multiply-add of y = h c) at the fp32
rate.  Special functions: one exp a (token, channel, state) on the SM's
special-function units."""
from __future__ import annotations

from perfbench import registry

# The program's kernels (csrc/mamba_scan.cu), by name: the prefill scan
# and the decode step; both take ``ScanArgs``.
KERNEL = r"\bscan_kernel\b.*ScanArgs"
STEP_KERNEL = r"\bstep_kernel\b.*ScanArgs"


def bound(B, S, di, N, *, itemsize=4):
    """(bound ms, what bounds it, bytes, flops); the port feeds the scan
    fp32 inputs (itemsize 4)."""
    peaks = registry.module("counts", "_peaks")
    nbytes = itemsize * (3 * B * S * di + 2 * B * S * N) \
        + 4 * di * N + 2 * 4 * B * di * N
    flops = 8.0 * B * S * di * N
    times = {"bytes": nbytes / peaks.HBM_BYTES_PER_S * 1e3,
             "operations": flops / peaks.FLOPS["float32"] * 1e3,
             "special-function": B * S * di * N / peaks.SFU_EXPS_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by, nbytes, flops
