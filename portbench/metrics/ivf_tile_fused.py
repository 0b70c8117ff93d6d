"""Share of the union calls whose window kernel selected each query's best
tile minima itself (kernel D's selecting epilogue), so that its full tile
minima never reached device memory: the root's ``tile_fused`` counter (1 or
0), mean over the slice's calls that ran the union. A program without the
counter gives None."""

from portbench.metrics._spans import calls, mean


def read(t):
    return mean(float(c.attrs["tile_fused"]) for c in calls(t)
                if "tile_fused" in c.attrs)
