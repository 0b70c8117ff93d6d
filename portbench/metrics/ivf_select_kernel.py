"""Union selections a call that took the program's selection kernel: the
root's ``select_kernel`` counter (0, 1 or 2: the probe selection, the
selection over the window kernel's tile minima), mean over the slice's
calls that ran the union. A program without the counter gives None."""

from portbench.metrics._spans import calls, mean


def read(t):
    return mean(c.attrs["select_kernel"] for c in calls(t)
                if "select_kernel" in c.attrs)
