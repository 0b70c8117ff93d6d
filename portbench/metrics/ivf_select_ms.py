"""Device ms a call of the IVF union's selection (top-k over the tile
minima, the exact rescore, the ids): the program's CUDA event pair around
``rii.select``, mean over the calls that ran the union."""

from portbench.metrics._spans import device_ms


def read(t):
    return device_ms(t, "rii.select")
