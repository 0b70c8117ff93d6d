"""Device ms a call of the IVF union's probe selection (coarse product,
probe sort, union): the program's CUDA event pair around ``rii.probe``,
mean over the calls that ran the union."""

from portbench.metrics._spans import device_ms


def read(t):
    return device_ms(t, "rii.probe")
