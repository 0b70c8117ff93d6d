"""Build and load the package's CUDA kernels and its host C++ library.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``; a
``csrc/<name>.cpp`` (the TexMex reader, ``texmex_native.cpp``) is compiled
for the host by ``g++`` with OpenMP. The build runs at first use, into
``build/rii_tpu_torch/`` at the root of the checkout, under a file name
keyed by a hash of the source, the shared headers (``.cu`` only) and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. Nothing here runs when the module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rii_tpu_torch"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
_HOST_FLAGS = ["-O3", "-fPIC", "-fopenmp", "-shared"]

_lock = threading.Lock()  # guards _name_locks
_name_locks = {}  # (name, defines, csrc) -> lock held while it is built and loaded
_loaded = {}  # (name, defines, csrc) -> ctypes.CDLL
build_seconds = {}  # library name -> seconds its build (or load) took


def _nvcc():
    cands = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in cands:
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (set CUDA_HOME)")
    return found


def _gxx():
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host C++ library is built "
                           "with g++ and OpenMP")
    return found


def _source(name, csrc):
    """``csrc/<name>.cu`` where it exists, else the host ``<name>.cpp``."""
    cu = csrc / f"{name}.cu"
    return cu if cu.exists() else csrc / f"{name}.cpp"


def _flags(defines, host=False):
    return (_HOST_FLAGS if host else _FLAGS) + [f"-D{d}" for d in defines]


def library_path(name, defines=(), csrc=None):
    """Where ``csrc/<name>.cu`` (or ``.cpp``) is built for the current
    source, the shared headers (``csrc/*.cuh``, for a ``.cu``), the flags
    and the preprocessor ``defines``; ``csrc`` another directory of sources
    (default: this package's)."""
    csrc = Path(csrc) if csrc is not None else _CSRC
    path = _source(name, csrc)
    host = path.suffix == ".cpp"
    headers = b"" if host else b"".join(
        p.read_bytes() for p in sorted(csrc.glob("*.cuh")))
    key = hashlib.sha256(path.read_bytes() + headers
                         + " ".join(_flags(defines, host)).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{name}-{key}.so"


def load_library(name, verbose=False, defines=(), csrc=None):
    """Build ``csrc/<name>.cu`` (nvcc) or ``csrc/<name>.cpp`` (g++) if
    needed and return the loaded library.
    ``defines`` ("NAME=VALUE" strings) build a variant of it, as the
    benchmarks' probe builds do; ``csrc`` builds the source of another
    checkout (``<checkout>/rii_tpu_torch/csrc``), as a benchmark's
    comparison with an earlier commit does. The kernels' wrappers load the
    plain one. Different libraries may build at the same time (one nvcc
    each)."""
    defines = tuple(defines)
    csrc = Path(csrc).resolve() if csrc is not None else _CSRC
    key = (name, defines, csrc)
    with _lock:
        lock = _name_locks.setdefault(key, threading.Lock())
    with lock:
        if key in _loaded:
            return _loaded[key]
        t0 = time.perf_counter()
        out = library_path(name, defines, csrc)
        if not out.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            src = _source(name, csrc)
            host = src.suffix == ".cpp"
            cmd = [_gxx() if host else _nvcc(), *_flags(defines, host)]
            if verbose and not host:
                cmd.insert(1, "-Xptxas=-v")
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            res = subprocess.run([*cmd, "-o", tmp, str(src)], capture_output=True,
                                 text=True)
            if res.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"{Path(cmd[0]).name} failed for {src.name}:\n"
                                   f"{res.stderr}")
            if verbose and res.stderr:
                print(res.stderr, end="")
            os.replace(tmp, out)  # atomic: a concurrent build sees all or none
        lib = ctypes.CDLL(str(out))
        if not defines and csrc == _CSRC:
            build_seconds[name] = time.perf_counter() - t0
        _loaded[key] = lib
        return lib


def configure(fn, argtypes):
    """A kernel's C entry ``fn`` with its argument types, set at its first
    call only (set again on every call they cost host time that a small
    kernel does not hide), and an int result: the CUDA error code."""
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(rc, what):
    """Raise if a kernel entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


_count_lock = threading.Lock()  # guards every wrapper's .launches


def count_launch(wrapper):
    """Add one to ``wrapper.launches``: under a lock, since a QueryServer's
    dispatcher threads launch concurrently and ``+=`` on an attribute is not
    atomic."""
    with _count_lock:
        wrapper.launches += 1
