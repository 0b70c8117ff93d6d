"""Engine host time before any device work a call (ms): the wall time of
the program's ``rii.prepare`` (checks, target-id sort, OPQ rotation, route
choice) and ``rii.upload`` (padding, the H2D of the queries, subset ids or
mask) spans, mean over the slice's calls."""

from portbench.metrics._spans import calls, mean


def read(t):
    return mean(c.wall_us("rii.prepare", "rii.upload") * 1e-3
                for c in calls(t))
