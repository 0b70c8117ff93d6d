"""TexMex dataset readers (fvecs / ivecs / bvecs; counterpart of
``rii_tpu.utils.io``).

Every vector is a little-endian int32 dimension d followed by d payload
elements (float32, int32 or uint8). The readers go through the native
library (``rii_tpu_torch.native``, built with g++ at first use) when it is
available, and memory-map the file with numpy otherwise; both paths give
the same arrays for every ``offset`` and ``count`` (a count past the end
is clamped to the records there).
"""

import numpy as np

from rii_tpu_torch import native as _native


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
    if _native.available():
        return _native.texmex_read(fname, "f", offset=offset, count=count)
    return _records(fname, count, offset).view(np.float32).copy()


def ivecs_read(fname, count=None, offset=0):
    """Read (N, D) int32 from an .ivecs file (ground-truth neighbour lists)."""
    if _native.available():
        return _native.texmex_read(fname, "i", offset=offset, count=count)
    return _records(fname, count, offset).copy()


def bvecs_read_batches(fname, batch_size, count=None):
    """Stream (B, D) uint8 batches from a .bvecs file."""
    if _native.available():
        _, total = _native.texmex_probe(fname, "b")
        n = total if count is None else min(count, total)
        for s in range(0, n, batch_size):
            yield _native.texmex_read(fname, "b", offset=s,
                                      count=min(batch_size, n - s))
        return
    raw = np.memmap(fname, dtype=np.uint8, mode="r")
    d = int(np.frombuffer(raw[:4].tobytes(), dtype=np.int32)[0])
    rec = 4 + d
    total = raw.shape[0] // rec
    n = total if count is None else min(count, total)
    for s in range(0, n, batch_size):
        ln = min(batch_size, n - s)
        chunk = raw[s * rec: (s + ln) * rec].reshape(ln, rec)[:, 4:]
        yield np.ascontiguousarray(chunk)
