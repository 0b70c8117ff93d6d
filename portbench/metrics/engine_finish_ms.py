"""Engine host time fetching the answers a call (ms): the wall time of the
program's ``rii.download`` spans (the D2H of ids and distances, their
casts) less the device-busy union inside them, mean over the slice's
calls."""

from portbench.metrics._spans import busy_us, calls, mean


def read(t):
    return mean(sum((b - a) - busy_us(t, a, b)
                    for a, b, _ in c.stages.get("rii.download", ())) * 1e-3
                for c in calls(t))
