"""ctypes bindings of the native TexMex reader (``csrc/texmex_native.cpp``;
counterpart of ``rii_tpu.native``).

The library is built by g++ with OpenMP at first use, through
``ops._build`` into ``build/rii_tpu_torch/``, as the CUDA sources are.
Where there is no compiler or the build fails, :func:`available` is False,
the error is kept in ``build_error``, and the readers of ``utils.io`` take
their numpy path. The readers here give the numpy path's answers for every
``offset`` and ``count``: a count past the end of the file is clamped to
the records there, and an empty read returns a (0, dim) array without a
call into the library. A failed read raises ``RuntimeError``.
"""

import ctypes
import os
import threading

import numpy as np

from rii_tpu_torch.ops import _build

_lock = threading.Lock()
_lib = None
_tried = False
build_error = None  # why the library is unavailable, once a load failed

_ELEM = {"f": (4, np.float32), "i": (4, np.int32), "b": (1, np.uint8)}


def _load():
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = _build.load_library("texmex_native")
        except (RuntimeError, OSError) as exc:
            build_error = str(exc)
            return None
        lib.rii_texmex_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.rii_texmex_probe.restype = ctypes.c_int
        lib.rii_texmex_read.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p]
        lib.rii_texmex_read.restype = ctypes.c_int
        lib.rii_texmex_read_b2f.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.rii_texmex_read_b2f.restype = ctypes.c_int
        _lib = lib
        return lib


def available():
    """True once the library is built and loaded (built at the first call)."""
    return _load() is not None


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native TexMex reader unavailable: {build_error}")
    return lib


def texmex_probe(path, kind):
    """Return (dim, count) of a TexMex file. kind in {'f','i','b'}."""
    lib = _library()
    elem_bytes, _ = _ELEM[kind]
    dim = ctypes.c_int64()
    count = ctypes.c_int64()
    rc = lib.rii_texmex_probe(os.fsencode(path), elem_bytes,
                              ctypes.byref(dim), ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"rii_texmex_probe failed for {path}: {rc}")
    return int(dim.value), int(count.value)


def _rows(total, offset, count):
    """The records a read of ``count`` (None: all) from ``offset`` returns,
    as the numpy path counts them."""
    n = total - offset if count is None else min(count, total - offset)
    return max(0, n)


def texmex_read(path, kind, offset=0, count=None):
    """Read the (count, dim) payload array of a TexMex file (parallel
    native copy)."""
    lib = _library()
    elem_bytes, dtype = _ELEM[kind]
    dim, total = texmex_probe(path, kind)
    n = _rows(total, offset, count)
    out = np.empty((n, dim), dtype=dtype)
    if n:
        rc = lib.rii_texmex_read(os.fsencode(path), elem_bytes, dim, offset, n,
                                 out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"rii_texmex_read failed for {path}: {rc}")
    return out


def bvecs_read_f32(path, offset=0, count=None):
    """Read a .bvecs payload directly as float32 (fused convert)."""
    lib = _library()
    dim, total = texmex_probe(path, "b")
    n = _rows(total, offset, count)
    out = np.empty((n, dim), dtype=np.float32)
    if n:
        rc = lib.rii_texmex_read_b2f(os.fsencode(path), dim, offset, n,
                                     out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"rii_texmex_read_b2f failed for {path}: {rc}")
    return out
