"""Share of the MoE layers' top-k assignments dropped at capacity over
the traced decode steps: 1 - the port's counters ``moe.kept`` over
``moe.assignments`` (``repro_torch.obs``, counted in
``moe._fill_capacity_buffers``), in %."""


def read(run):
    if run.traced_wave is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:         # a port without counters
        return None
    c = obs.counters().get("decode_step", {})
    if not c.get("moe.assignments"):
        return None
    return 100.0 * (1.0 - c["moe.kept"] / c["moe.assignments"])
