"""Host milliseconds a call of ``LM.decode_step`` takes to return (it
returns before the card finishes), the mean over the window's decode
steps.  Left out: each wave's first step, which is enqueued behind the
prefill and waits for the launch queue to drain, and the traced wave's,
which the profiler slows."""


def read(run):
    xs = [s for w in run.waves if w.traced is None and w.start < run.t_end
          for s in w.enqueue[1:]]
    return 1e3 * sum(xs) / len(xs) if xs else None
