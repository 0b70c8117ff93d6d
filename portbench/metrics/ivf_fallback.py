"""Share of the slice's calls whose IVF route fell back: to the linear scan
(``route`` ``ivf_to_linear``: the probes cover the index, or the union half
its capacity) or to a second, widened pass (``ivf_widened``: too few
candidates found)."""

from portbench.metrics._spans import calls, mean

FALLBACKS = ("ivf_to_linear", "ivf_widened")


def read(t):
    return mean(float(c.attrs.get("route") in FALLBACKS) for c in calls(t)
                if "route" in c.attrs)
