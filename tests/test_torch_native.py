"""The port's native TexMex reader (rii_tpu_torch.native, built by g++
from rii_tpu_torch/csrc/texmex_native.cpp into build/rii_tpu_torch/) and
the readers of rii_tpu_torch.utils.io through it, against the numpy path
of rii_tpu.utils.io on synthetic files.

rii_tpu's readers answer differently with and without their library: its
native path passes a count past the end of the file (or 0) on to the C
code, which fails, where its numpy path clamps. The port's readers give
the numpy path's answer whichever way they read."""

import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import rii_tpu.native
from rii_tpu.utils import io as jio
from rii_tpu_torch import native
from rii_tpu_torch.ops import _build
from rii_tpu_torch.utils import io as tio

REPO = Path(__file__).resolve().parents[1]
ROWS = 37


@pytest.fixture(scope="module")
def built():
    """The port's library, built (or loaded) with g++; skips where the
    machine has no g++."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the native reader cannot build")
    assert native.available(), native.build_error
    return native


def _write(path, arr):
    with open(path, "wb") as f:
        for row in arr:
            f.write(struct.pack("<i", arr.shape[1]))
            f.write(row.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("texmex")
    rng = np.random.RandomState(0)
    arrs = {"f": rng.random((ROWS, 16)).astype(np.float32),
            "i": rng.randint(-1000, 1000, (ROWS, 8)).astype(np.int32),
            "b": rng.randint(0, 256, (ROWS, 12)).astype(np.uint8)}
    ext = {"f": "fvecs", "i": "ivecs", "b": "bvecs"}
    return {k: (_write(d / f"x.{ext[k]}", a), a) for k, a in arrs.items()}


@pytest.fixture
def jax_numpy_path(monkeypatch):
    """rii_tpu's readers on their numpy path."""
    monkeypatch.setattr(rii_tpu.native, "available", lambda: False)


def _jax_read(kind, path, offset, count):
    if kind == "b":
        raw = list(jio.bvecs_read_batches(path, batch_size=10 ** 6,
                                          count=None if count is None else offset + count))
        whole = np.concatenate(raw) if raw else np.zeros((0, 12), np.uint8)
        return whole[offset:]
    fn = jio.fvecs_read if kind == "f" else jio.ivecs_read
    return fn(path, count=count, offset=offset)


# (offset, count): everything, a window, a count past the end, none, the tail
WINDOWS = [(0, None), (5, 10), (8, ROWS), (30, 20), (0, 0), (ROWS - 1, None), (ROWS, None)]


@pytest.mark.parametrize("kind", ["f", "i", "b"])
@pytest.mark.parametrize("offset,count", WINDOWS)
def test_native_read_gives_the_numpy_paths_answer(built, files, jax_numpy_path,
                                                  kind, offset, count):
    path, arr = files[kind]
    assert native.texmex_probe(path, kind) == (arr.shape[1], ROWS)
    got = native.texmex_read(path, kind, offset=offset, count=count)
    ref = _jax_read(kind, path, offset, count)
    assert got.dtype == ref.dtype == arr.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    n = ROWS - offset if count is None else min(count, ROWS - offset)
    np.testing.assert_array_equal(got, arr[offset:offset + n])
    if kind == "b":
        f32 = native.bvecs_read_f32(path, offset=offset, count=count)
        assert f32.dtype == np.float32
        np.testing.assert_array_equal(f32, ref.astype(np.float32))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("offset,count", WINDOWS[:-1])
def test_readers_match_rii_tpus_numpy_path(built, files, jax_numpy_path,
                                           monkeypatch, use_native, offset, count):
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    for kind, fn in (("f", tio.fvecs_read), ("i", tio.ivecs_read)):
        path, _ = files[kind]
        got = fn(path, count=count, offset=offset)
        ref = _jax_read(kind, path, offset, count)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    path, arr = files["b"]
    for cnt in (None, 0, 15, ROWS + 5):
        got = list(tio.bvecs_read_batches(path, batch_size=10, count=cnt))
        ref = list(jio.bvecs_read_batches(path, batch_size=10, count=cnt))
        assert [g.shape for g in got] == [r.shape for r in ref]
        for g, r in zip(got, ref):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, r)


def test_a_failed_build_leaves_the_numpy_path(files, monkeypatch):
    """No compiler, or a build that fails: available() is False, the error
    is kept, and the readers answer from the numpy path."""
    def fail(name, **kw):
        raise RuntimeError("g++ failed for texmex_native.cpp:\nfatal error: omp.h: "
                           "No such file or directory")

    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_error", None)
    monkeypatch.setattr(_build, "load_library", fail)
    assert not native.available()
    assert "omp.h" in native.build_error
    with pytest.raises(RuntimeError, match="unavailable: g\\+\\+ failed"):
        native.texmex_probe(files["f"][0], "f")
    path, arr = files["f"]
    np.testing.assert_array_equal(tio.fvecs_read(path, count=50, offset=30), arr[30:])
    assert tio.fvecs_read(path, count=0).shape == (0, 16)


def test_the_compilers_error_is_raised(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    (tmp_path / "broken.cpp").write_text('#include "no_such_header.h"\n')
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed for broken.cpp:.*no_such_header"):
        _build.load_library("broken", csrc=tmp_path)
    assert not _build.library_path("broken", csrc=tmp_path).exists()


def test_library_path_is_keyed_by_the_cpp_source(tmp_path):
    shutil.copy(_build._CSRC / "texmex_native.cpp", tmp_path)
    same = _build.library_path("texmex_native", csrc=tmp_path)
    assert same == _build.library_path("texmex_native")
    assert same.parent == REPO / "build" / "rii_tpu_torch"
    (tmp_path / "extra.cuh").write_text("// a CUDA header the host build ignores\n")
    assert _build.library_path("texmex_native", csrc=tmp_path) == same
    src = tmp_path / "texmex_native.cpp"
    src.write_text(src.read_text() + "\n")
    assert _build.library_path("texmex_native", csrc=tmp_path) != same


_PROBE = r'''
import os, sys
sys.modules["jax"] = None
sys.modules["rii_tpu"] = None  # the port must not reach the JAX package
repo, data = sys.argv[1], sys.argv[2]
sys.path.insert(0, repo)
events = []


def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        events.append(("open", os.fsdecode(args[0])))
    elif event == "subprocess.Popen":
        events.append(("popen", " ".join(map(os.fsdecode, args[1] or []))))
    elif event == "ctypes.dlopen" and args[0]:
        events.append(("dlopen", os.fsdecode(args[0])))


sys.addaudithook(hook)
from rii_tpu_torch import native
from rii_tpu_torch.ops import _build
from rii_tpu_torch.utils import io
assert native.available(), native.build_error
assert io.fvecs_read(data).shape == (37, 16)
jax_native = os.path.join(repo, "rii_tpu", "native")
for kind, what in events:
    assert not os.path.abspath(what).startswith(jax_native), (kind, what)
    assert not (kind == "popen" and "make" in what.split()), what
lib = str(_build.library_path("texmex_native"))
assert lib.startswith(os.path.join(repo, "build", "rii_tpu_torch") + os.sep), lib
assert ("dlopen", lib) in events, events
print("ok")
'''


def _listing(d):
    """Name -> mtime of each file; the library rii_tpu's own loader builds
    there by name only (another test process may be running that build)."""
    return {p.name: None if p.suffix == ".so" else p.stat().st_mtime_ns
            for p in sorted(Path(d).iterdir())}


def test_build_lands_in_build_and_leaves_rii_tpu_native_alone(built, files):
    """In a process where rii_tpu and jax cannot be imported, the port
    builds (or loads) its library from build/rii_tpu_torch/, opens nothing
    under rii_tpu/native/ and runs no make; the listing and the times of
    rii_tpu/native/ are the same before and after."""
    jax_native = REPO / "rii_tpu" / "native"
    rii_tpu.native.available()  # the JAX package's own build, settled first
    before = _listing(jax_native)
    res = subprocess.run([sys.executable, "-c", _PROBE, str(REPO), files["f"][0]],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    assert _listing(jax_native) == before
    assert _build.library_path("texmex_native").exists()
