"""train_host_ms: host time a training step inside the program's
`uncltmo.train.step` span, from the span's intervals in the traced
stretch's profiler trace (the profiler's clock): from the step's call to
its return, launches and waits included."""

SPAN = "uncltmo.train.step"


def read(run):
    if run.trace is None or not run.traced_items:
        return None
    steps = [e - s for spans in run.trace.spans.values()
             for s, e, name in spans if name == SPAN]
    if not steps:
        return None
    return 1e3 * sum(steps) / run.traced_items
