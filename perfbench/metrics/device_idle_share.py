"""Share of the traced slice in which no operation ran on the device:
1 - (the union of the device ops' intervals / the slice), in %."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.span[1] <= t.span[0]:
        return None
    return 100.0 * (1.0 - t.busy() / (t.span[1] - t.span[0]))
