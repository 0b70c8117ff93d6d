"""Frozen device-busy arithmetic.

Copied from ``chip_profile_pq.device_busy``: the busy time of the device
is the union of its kernels' intervals, so that overlapping kernels count
once. Frozen here so that the program's changes cannot move it.
"""


def merged(intervals):
    """Sorted, merged (start, end) intervals of ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_within(intervals, lo, hi):
    """Length of the union of ``intervals`` inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged(intervals)
               if b > lo and a < hi)


def gaps(intervals, lo, hi):
    """The idle (start, end) stretches of [lo, hi] outside ``intervals``."""
    out, cur = [], lo
    for a, b in merged(intervals):
        if b <= lo or a >= hi:
            continue
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < hi:
        out.append((cur, hi))
    return out
