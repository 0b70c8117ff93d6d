"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The build runs at
first use, into ``build/rii_tpu_torch/`` at the root of the checkout, under a
file name keyed by a hash of the source, the shared headers and the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is. Nothing here runs when the
module is imported.
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


def _flags(defines):
    return _FLAGS + [f"-D{d}" for d in defines]


def library_path(name, defines=(), csrc=None):
    """Where ``csrc/<name>.cu`` is built for the current source, the shared
    headers (``csrc/*.cuh``), the flags and the preprocessor ``defines``;
    ``csrc`` another directory of sources (default: this package's)."""
    csrc = Path(csrc) if csrc is not None else _CSRC
    src = (csrc / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(csrc.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{name}-{key}.so"


def load_library(name, verbose=False, defines=(), csrc=None):
    """Build ``csrc/<name>.cu`` if needed and return the loaded library.
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
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *_flags(defines), "-o", tmp, str(csrc / f"{name}.cu")]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
            if verbose and res.stderr:
                print(res.stderr, end="")
            os.replace(tmp, out)  # atomic: a concurrent build sees all or none
        lib = ctypes.CDLL(str(out))
        if not defines and csrc == _CSRC:
            build_seconds[name] = time.perf_counter() - t0
        _loaded[key] = lib
        return lib


def check(rc, what):
    """Raise if a kernel entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
