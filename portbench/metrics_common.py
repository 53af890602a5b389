"""Arithmetic that several metric readers share."""
from __future__ import annotations


def device_ms_per_item(run, spans):
    """Device time of the operations launched inside any of `spans`, per
    frame (or step) of the traced stretch, ms."""
    if run.trace is None or not run.traced_items:
        return None
    ops = [(s, e) for s, e, _, names in run.trace.ops
           if any(n in names for n in spans)]
    if not ops:
        return None
    from portbench import measure
    return 1e3 * measure.busy_time(ops, *run.trace.window) / run.traced_items


def idle_pct(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mean_host_ms(run, name):
    if run.spans is None:
        return None
    ms = run.spans.host_ms(name)
    return sum(ms) / len(ms) if ms else None
