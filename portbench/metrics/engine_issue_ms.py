"""Engine host time issuing the device work a call (ms): the wall time of
the program's ``rii.probe``, ``rii.scan`` and ``rii.select`` spans (the
coarse scores and union, the scan kernel's wrapper, top-k and rescore), mean
over the slice's calls. A synchronise hidden in them shows here."""

from portbench.metrics._spans import calls, mean


def read(t):
    return mean(c.wall_us("rii.probe", "rii.scan", "rii.select") * 1e-3
                for c in calls(t))
