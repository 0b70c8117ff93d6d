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
_name_locks = {}  # library name -> lock held while it is built and loaded
_loaded = {}  # library name -> ctypes.CDLL
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


def library_path(name):
    """Where ``csrc/<name>.cu`` is built for the current source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    src = (_CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{name}-{key}.so"


def load_library(name, verbose=False):
    """Build ``csrc/<name>.cu`` if needed and return the loaded library.
    Different libraries may build at the same time (one nvcc each)."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        t0 = time.perf_counter()
        out = library_path(name)
        if not out.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
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
        build_seconds[name] = time.perf_counter() - t0
        _loaded[name] = lib
        return lib


def check(rc, what):
    """Raise if a kernel entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
