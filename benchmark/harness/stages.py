"""What the program's own spans say in a traced window.

doa_tpu_torch opens a span named ``doa.<stage>`` around each stage of a
call (``doa.call`` around the whole call; ``doa.sync.<where>`` around each
host read that waits for the card), on the device trace's clock. The
harness's spans around the program's entries (tracing.install_spans) open
inside the stage spans, so a device op's innermost span may be an entry
nested in a stage: a stage's ops are those whose innermost span is the
stage's span or a span nested inside its instances. On a program that
opens no such span every reader here finds nothing and says so.
"""

from __future__ import annotations

from fnmatch import fnmatchcase

from harness.roofline import bound_s

CALL = "doa.call"
SYNCS = "doa.sync.*"


def instances(trace, pattern: str) -> list:
    """[(start, end)] µs of the window's spans whose name matches
    `pattern` (fnmatch: ``doa.sync.*``)."""
    return [(a, b) for a, b, name in trace.spans
            if fnmatchcase(name, pattern) and b >= trace.t0 and a <= trace.t1]


def count_per_call(trace, pattern: str) -> float:
    """Instances a call of the spans matching `pattern`."""
    return len(instances(trace, pattern)) / trace.n_calls


def family(trace, name: str):
    """(`name` and the names of the spans nested inside its instances, by
    interval containment, or None, why not). A nested name that also opens
    outside every instance is ambiguous: its ops could not be told apart."""
    inst = instances(trace, name)
    if not inst:
        return None, f"no {name} span in the window"
    inside, outside = set(), set()
    for a, b, n in trace.spans:
        if n == name or b < trace.t0 or a > trace.t1:
            continue
        if any(lo <= a and b <= hi for lo, hi in inst):
            inside.add(n)
        else:
            outside.add(n)
    both = inside & outside
    if both:
        return None, f"{sorted(both)} open both inside and outside {name}"
    return inside | {name}, None


def idle_s_inside(trace, name: str) -> float:
    """Seconds of the window inside `name`'s instances in which no device
    op ran: each instance's length less the union of the ops' intervals
    clipped to it."""
    merged = []
    for a, b, _, _ in trace.ops:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    idle = 0.0
    for lo, hi in instances(trace, name):
        lo, hi = max(lo, trace.t0), min(hi, trace.t1)
        busy = sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)
        idle += max(0.0, hi - lo - busy)
    return idle * 1e-6


def stage_roofline(ctx, name: str, twin: str):
    """100 × the bound of the twin metric's work (ctx.works[twin], the
    layer's work as the twin counts it) over the device time a call of
    the ops launched under the program's span `name`; None where either
    is missing."""
    if twin not in ctx.works:
        ctx.note(f"no work of {twin} in this cell")
        return None
    names, why = family(ctx.trace, name)
    if names is None:
        ctx.note(why)
        return None
    t = ctx.trace.device_s_per_call(names)
    if t <= 0:
        ctx.note(f"no device op launched under {name}")
        return None
    return 100.0 * bound_s(ctx.works[twin]) / t
