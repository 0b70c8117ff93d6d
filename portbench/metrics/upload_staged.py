"""Share of the slice's calls whose queries reached the card through the
engine's page-locked staging buffer: the root's ``upload_staged`` counter
(1 or 0), mean over the calls that carry it. A program without the counter
gives None."""

from portbench.metrics._spans import calls, mean


def read(t):
    return mean(float(c.attrs["upload_staged"]) for c in calls(t)
                if "upload_staged" in c.attrs)
