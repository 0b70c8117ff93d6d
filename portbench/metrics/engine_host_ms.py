"""Engine host time per call (ms): each ``query_batch`` span's wall time
less the device-busy union inside it, mean over the slice's calls (routing,
padding, copies of queries and results, subset ids)."""


def read(t):
    if not t.calls:
        return None
    host = [(b - a) - t.busy_us(a, b) for a, b, _ in t.calls]
    return sum(host) / len(host) * 1e-3
