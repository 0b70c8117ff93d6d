"""How many times kernel D decoded each slot tile of the union, mean over the
slice's calls that ran it: the root's ``tile_decodes`` counter (its query
blocks of 128 rows over the blocks of a thread-block cluster: 2 at Q=512,
where its four blocks run as two pairs). A program without the counter
gives None."""

from portbench.metrics._spans import calls, mean


def read(t):
    return mean(float(c.attrs["tile_decodes"]) for c in calls(t)
                if "tile_decodes" in c.attrs)
