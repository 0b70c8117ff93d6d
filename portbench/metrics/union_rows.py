"""Live rows of the IVF union's distinct windows per query: the program's
``union_rows`` counter over its ``queries`` (before padding), mean over the
calls that ran the union."""

from portbench.metrics._spans import calls, mean


def read(t):
    return mean(c.attrs["union_rows"] / c.attrs["queries"]
                for c in calls(t)
                if "union_rows" in c.attrs and c.attrs.get("queries"))
