"""TexMex dataset readers (fvecs / ivecs / bvecs), numpy only (counterpart
of ``rii_tpu.utils.io`` without its native loader).

Every vector is a little-endian int32 dimension d followed by d payload
elements (float32, int32 or uint8); the files are memory-mapped.
"""

import numpy as np


def _records(fname, count, offset):
    """(rows, d) int32 view of records [offset, offset + count)."""
    x = np.memmap(fname, dtype=np.int32, mode="r")
    d = int(x[0])
    rec = d + 1
    total = x.shape[0] // rec
    n = total - offset if count is None else min(count, total - offset)
    return x[offset * rec: (offset + n) * rec].reshape(n, rec)[:, 1:]


def fvecs_read(fname, count=None, offset=0):
    """Read (N, D) float32 from an .fvecs file."""
    return _records(fname, count, offset).view(np.float32).copy()


def ivecs_read(fname, count=None, offset=0):
    """Read (N, D) int32 from an .ivecs file (ground-truth neighbour lists)."""
    return _records(fname, count, offset).copy()


def bvecs_read_batches(fname, batch_size, count=None):
    """Stream (B, D) uint8 batches from a .bvecs file."""
    raw = np.memmap(fname, dtype=np.uint8, mode="r")
    d = int(np.frombuffer(raw[:4].tobytes(), dtype=np.int32)[0])
    rec = 4 + d
    total = raw.shape[0] // rec
    n = total if count is None else min(count, total)
    for s in range(0, n, batch_size):
        ln = min(batch_size, n - s)
        chunk = raw[s * rec: (s + ln) * rec].reshape(ln, rec)[:, 4:]
        yield np.ascontiguousarray(chunk)
