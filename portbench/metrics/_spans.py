"""The program's own spans on the traced slice, for the readers of the
engine's stages (``engine_prep_ms``, ``engine_issue_ms``,
``engine_finish_ms``, ``ivf_probe_ms``, ``ivf_select_ms``, ``union_rows``,
``ivf_fallback``).

The program (``rii_tpu_torch.utils.profiling.spans``) records each
``query_batch`` call while the profiler records: a root span whose
attributes hold the call's counters (``route``, ``queries``,
``union_rows``) and the ``perf_counter_ns`` it read inside its
``rii.clock`` mark, and stage spans (``rii.prepare``, ``rii.upload``,
``rii.probe``, ``rii.scan``, ``rii.select``, ``rii.download``; probe and
select with ``device_ms``). Each root is placed on the profiler's timeline
through its own mark, a host event in ``t.host_ops`` (the mark's midpoint is
the clock it read); marks and roots are paired in order from the last.
A program without the recorder gives no calls."""

import bisect
from collections import defaultdict

from portbench.reference.busy import merged

MARK = "rii.clock"


class Call:
    """One ``query_batch`` call inside the slice: ``start``, ``end``
    (microseconds on the profiler's timeline), ``attrs`` (the root's
    counters) and ``stages``: name -> [(start, end, attrs)]."""

    def __init__(self, start, end, attrs, stages):
        self.start, self.end, self.attrs, self.stages = start, end, attrs, stages

    def wall_us(self, *names):
        return sum(b - a for n in names for a, b, _ in self.stages.get(n, ()))


def calls(t):
    """The program's calls that lie inside [t.lo, t.hi], oldest first."""
    cached = getattr(t, "_program_calls", None)
    if cached is not None:
        return cached
    try:
        from rii_tpu_torch.utils.profiling import spans
    except ImportError:
        return []
    records = spans()
    marks = sorted(0.5 * (a + b) for name, a, b in t.host_ops if name == MARK)
    roots = sorted((r for r in records
                    if r.parent is None and "clock_ns" in r.attrs),
                   key=lambda r: r.attrs["clock_ns"])
    kids = defaultdict(list)
    for r in records:
        if r.parent is not None:
            kids[r.call].append(r)
    n = min(len(marks), len(roots))
    out = []
    for mark, root in zip(marks[len(marks) - n:], roots[len(roots) - n:]):
        off = mark - root.attrs["clock_ns"] * 1e-3
        start, end = root.start_ns * 1e-3 + off, root.end_ns * 1e-3 + off
        if start < t.lo or end > t.hi:
            continue
        stages = defaultdict(list)
        for k in kids[root.id]:
            stages[k.name].append((k.start_ns * 1e-3 + off,
                                   k.end_ns * 1e-3 + off, k.attrs))
        out.append(Call(start, end, root.attrs, stages))
    t._program_calls = out
    return out


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def device_ms(t, stage):
    """Device ms of ``stage``'s event pairs a call, mean over the calls that
    recorded one."""
    per = []
    for c in calls(t):
        ms = [a.get("device_ms") for _, _, a in c.stages.get(stage, ())]
        ms = [m for m in ms if m is not None]
        if ms:
            per.append(sum(ms))
    return mean(per)


def busy_us(t, a, b):
    """``t.busy_us(a, b)``, the union of kernel intervals inside [a, b],
    from one merge of the slice's kernels (kept on ``t``) rather than one a
    call."""
    m = getattr(t, "_merged_kernels", None)
    if m is None:
        m = t._merged_kernels = merged([(x, y) for _, x, y in t.kernels])
        t._merged_starts = [x for x, _ in m]
    i = max(0, bisect.bisect_right(t._merged_starts, a) - 1)
    total = 0.0
    for x, y in m[i:]:
        if x >= b:
            break
        total += max(0.0, min(y, b) - max(x, a))
    return total
