"""The port's package exports against rii_tpu's: the ``__all__`` of the
package and of ``ops``, ``models``, ``utils`` and ``parallel`` name the same
objects, and importing every one of them, with ``jax`` blocked, imports
nothing of ``rii_tpu`` and builds and loads no library."""

import importlib
import subprocess
import sys
from pathlib import Path

import pytest

SUBPACKAGES = ["", ".ops", ".models", ".utils", ".parallel"]


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "package")
def test_all_equals_rii_tpus(sub):
    jm = importlib.import_module("rii_tpu" + sub)
    tm = importlib.import_module("rii_tpu_torch" + sub)
    assert tm.__all__ == jm.__all__
    for name in tm.__all__:
        assert hasattr(tm, name), name
        obj = getattr(tm, name)
        if callable(obj):  # the port's own counterpart, not rii_tpu's object
            assert obj.__module__.startswith("rii_tpu_torch"), (name, obj.__module__)


_IMPORT = r'''
import sys
sys.modules["jax"] = None  # the port must not need jax
events = []  # processes started, libraries of this checkout loaded
sys.addaudithook(lambda ev, args: events.append((ev, args))
                 if ev == "subprocess.Popen" or (ev == "ctypes.dlopen" and args[0]
                                                 and "rii_tpu" in str(args[0]))
                 else None)
import rii_tpu_torch, rii_tpu_torch.ops, rii_tpu_torch.models
import rii_tpu_torch.utils, rii_tpu_torch.parallel, rii_tpu_torch.native
import rii_tpu_torch.utils.oracle, rii_tpu_torch.models.kmeans
from rii_tpu_torch.ops import _build
assert not [m for m in sys.modules if m == "rii_tpu" or m.startswith("rii_tpu.")]
assert not _build._loaded and not _build.build_seconds
assert rii_tpu_torch.native._lib is None and not rii_tpu_torch.native._tried
assert not events, events
print(len(rii_tpu_torch.ops.__all__ + rii_tpu_torch.models.__all__))
'''


def test_imports_without_jax_and_builds_nothing():
    res = subprocess.run([sys.executable, "-c", _IMPORT], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "9"
