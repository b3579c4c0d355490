"""Share of the MoE layers' capacity slots that hold a token in the
traced prefill: the port's counters ``moe.kept`` over ``moe.slots``
(``repro_torch.obs``, counted in ``moe._fill_capacity_buffers``), in %.
At most 100 / capacity factor where factor·T·k/E is whole (the capacity
is its floor)."""


def read(run):
    if run.traced_wave is None or run.traced_wave.traced[0] != 0:
        return None
    try:
        from repro_torch import obs
    except ImportError:         # a port without counters
        return None
    c = obs.counters().get("prefill", {})
    if not c.get("moe.slots"):
        return None
    return 100.0 * c["moe.kept"] / c["moe.slots"]
