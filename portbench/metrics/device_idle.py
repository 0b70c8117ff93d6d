"""Share of the traced slice in which no kernel ran on the device (one less
the union of kernel intervals over the slice)."""


def read(t):
    if t.window_us <= 0 or not t.kernels:
        return None
    return 1.0 - t.busy_us() / t.window_us
