"""Whole runs of tiny cells on the CPU: the last line's keys, the import
check, no run without a card, and the check that decides ``correct``
failing the control and a broken timed path."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import rii_tpu_torch.models.pq as pq_mod
import rii_tpu_torch.rii as rii_mod
from portbench.harness.spec import HOME, ROOT, Bench
from portbench.run import forbidden_modules, run_cell
from portbench.tests._tiny import make_tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", ["tiny.bulk", "tiny.subset"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(tiny, cell, trace):
    out = run_cell(tiny, cell, SEED, 0.6, bool(trace), CPU)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    c = tiny.cell(cell)
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
        if "recall10" in names:
            assert out["metrics"]["recall10"]["value"] > 0
    else:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "build_cache_s" in out["metrics"]
    for k, v in out["checks"].items():
        assert set(v) == {"value", "limit"}
    json.dumps(out, allow_nan=False)


@pytest.mark.parametrize("control,fails", [
    ("terms", ("dist_gap", "dist_mean", "code_excess")),
    ("rows", ("dist_gap", "dist_mean", "code_excess")),
    ("half", ("sel_miss",))])
@pytest.mark.parametrize("cell", ["tiny.bulk", "tiny.subset"])
def test_control_is_not_correct(tiny, cell, control, fails):
    out = run_cell(tiny, cell, SEED + 1, 0.3, False, CPU, control=control)
    assert out["correct"] is False
    chk = out["checks"]
    for k in fails:
        assert chk[k]["value"] > chk[k]["limit"], (k, chk)


def _half_batch(orig):
    def query_batch(self, queries, *a, **kw):
        h = max(1, -(-len(queries) // 2))
        ids, d = orig(self, queries[:h], *a, **kw)
        rep = -(-len(queries) // h)
        return np.tile(ids, (rep, 1))[:len(queries)], np.tile(d, (rep, 1))[:len(queries)]
    return query_batch


def _altered_answer(orig):
    def query_batch(self, queries, *a, **kw):
        ids, d = orig(self, queries, *a, **kw)
        ids = ids.copy()
        ids[:, 0] = (ids[:, 0] + 1) % self.N
        return ids, d
    return query_batch


def _half_index(orig):
    """The search over the first half of the index only."""
    def query_batch(self, queries, *a, **kw):
        ids = kw.get("target_ids")
        ids = np.arange(self.N) if ids is None else np.asarray(ids)
        kw["target_ids"] = ids[ids < self.N // 2]
        return orig(self, queries, *a, **kw)
    return query_batch


@pytest.mark.parametrize("fault,cell", [
    (_half_batch, "tiny.bulk"), (_half_batch, "tiny.subset"),
    (_altered_answer, "tiny.bulk"), (_altered_answer, "tiny.subset"),
    (_half_index, "tiny.bulk"), (_half_index, "tiny.subset")])
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, fault, cell):
    monkeypatch.setattr(rii_mod.Rii, "query_batch",
                        fault(rii_mod.Rii.query_batch))
    out = run_cell(tiny, cell, SEED + 2, 0.3, False, CPU)
    assert out["correct"] is False, out["checks"]


def _no_iterations(orig):
    def fit(self, vecs, iter=20, seed=None):
        return orig(self, vecs, iter=0, seed=seed)
    return fit


def _wrong_split(orig):
    """Each sub-space's codewords fitted on the next sub-space's columns."""
    def fit(self, vecs, iter=20, seed=None):
        shift = vecs.shape[1] // self.M
        return orig(self, np.roll(vecs, shift, axis=1), iter=iter, seed=seed)
    return fit


@pytest.mark.parametrize("fault", [_no_iterations, _wrong_split])
def test_broken_codec_fit_is_not_correct(tiny, monkeypatch, fault):
    monkeypatch.setattr(pq_mod.PQ, "fit", fault(pq_mod.PQ.fit))
    out = run_cell(tiny, "tiny.bulk", SEED + 4, 0.3, False, CPU)
    assert out["correct"] is False
    chk = out["checks"]["fit_excess"]
    assert chk["value"] > chk["limit"], out["checks"]


def test_import_check_compares_whole_top_level_names(monkeypatch):
    assert "rii_tpu_torch" in sys.modules
    assert forbidden_modules() == []
    for name in ("rii_tpu.models", "jaxlib", "jax_like_name_is_fine"):
        monkeypatch.setitem(sys.modules, name, object())
    assert forbidden_modules() == ["jaxlib", "rii_tpu"]


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sift1m_m64.bulk",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run_py(ROOT)
    assert res.returncode != 0 and res.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HOME, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run_py(tmp_path)
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("control", [None, "terms", "rows", "half"])
def test_card_control_separates(control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run_cell(Bench(), "sift1m_m64.bulk", SEED + 3, 1.0, False,
                   torch.device("cuda", 0), control=control)
    assert out["correct"] is (control is None), out["checks"]
