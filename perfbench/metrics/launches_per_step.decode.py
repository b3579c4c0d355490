"""Device ops a decode step launches: the mean over the traced decode
steps of the ops launched inside the port's span
``repro_torch.decode_step``, less those inside ``repro_torch.obs`` (the
counters' own updates)."""


def read(run):
    t = run.trace
    if t is None:
        return None
    steps = t.marked("repro_torch.decode_step")
    if not steps:
        return None
    counting = {id(o) for _, ops in t.marked("repro_torch.obs") for o in ops}
    launched = sum(id(o) not in counting for _, ops in steps for o in ops)
    return launched / len(steps)
