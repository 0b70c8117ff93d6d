"""The port's TexMex readers (rii_tpu_torch.utils.io) against
rii_tpu's, on synthetic files: the cases of tests/test_io.py."""

import struct

import numpy as np

from rii_tpu.utils import io as jio
from rii_tpu_torch.utils import io as tio


def _write(path, arr, fmt):
    with open(path, "wb") as f:
        for row in arr:
            f.write(struct.pack("<i", arr.shape[1]))
            f.write(row.astype(fmt).tobytes())


def test_fvecs_roundtrip(tmp_path):
    arr = np.random.RandomState(0).random((50, 16)).astype(np.float32)
    p = str(tmp_path / "x.fvecs")
    _write(p, arr, "<f4")
    np.testing.assert_array_equal(tio.fvecs_read(p), arr)
    np.testing.assert_array_equal(tio.fvecs_read(p, count=10, offset=5), arr[5:15])
    np.testing.assert_array_equal(tio.fvecs_read(p, offset=45), arr[45:])
    np.testing.assert_array_equal(tio.fvecs_read(p), jio.fvecs_read(p))
    assert tio.fvecs_read(p).dtype == np.float32


def test_ivecs_roundtrip(tmp_path):
    arr = np.random.RandomState(0).randint(0, 1000, (30, 8)).astype(np.int32)
    p = str(tmp_path / "x.ivecs")
    _write(p, arr, "<i4")
    np.testing.assert_array_equal(tio.ivecs_read(p), arr)
    np.testing.assert_array_equal(tio.ivecs_read(p, count=4, offset=2),
                                  jio.ivecs_read(p, count=4, offset=2))


def test_bvecs_batches(tmp_path):
    arr = np.random.RandomState(0).randint(0, 256, (37, 12)).astype(np.uint8)
    p = str(tmp_path / "x.bvecs")
    _write(p, arr, np.uint8)
    batches = list(tio.bvecs_read_batches(p, batch_size=10))
    np.testing.assert_array_equal(np.concatenate(batches), arr)
    assert batches[0].shape == (10, 12) and batches[-1].shape == (7, 12)
    capped = list(tio.bvecs_read_batches(p, batch_size=10, count=15))
    ref = list(jio.bvecs_read_batches(p, batch_size=10, count=15))
    assert [b.shape for b in capped] == [b.shape for b in ref] == [(10, 12), (5, 12)]
    for a, b in zip(capped, ref):
        np.testing.assert_array_equal(a, b)
