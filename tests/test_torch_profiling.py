"""The port's profiling helpers (rii_tpu_torch.utils.profiling): the cases
of tests/test_profiling.py on a CPU engine. Times here are the host's;
only their signs and the keys are checked."""

import json
import os

import numpy as np
import pytest

import rii_tpu
import rii_tpu.utils.profiling as jprof
from rii_tpu_torch import PQ, Rii
from rii_tpu_torch.utils import benchmark_queries, measure_rtt, trace
from rii_tpu_torch.utils.convert import engine_from_arrays


def _engine():
    X = np.random.RandomState(0).random((2000, 32)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=16, device="cpu").fit(X[:500], iter=2))
    e.add_configure(X, nlist=20, iter=2)
    return e, X


def test_measure_rtt_positive():
    assert measure_rtt(reps=2, device="cpu") > 0


def test_measure_rtt_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        measure_rtt(reps=1)


def test_benchmark_queries_reports_qps_and_recall():
    e, X = _engine()
    out = benchmark_queries(e, X[:16], topk=5, reps=1, gt_ids=np.arange(16))
    assert out["qps"] > 0 and out["ms_per_query"] > 0
    assert 0.0 <= out["recall@1"] <= 1.0
    assert out["recall@5"] >= out["recall@1"]


def test_benchmark_queries_keys_and_recall_match_rii_tpu():
    X = np.random.RandomState(1).random((2000, 32)).astype(np.float32)
    # M=8: no two rows share a code, so no exact tie decides a recall (the
    # packages order exact ties differently)
    je = rii_tpu.Rii(rii_tpu.PQ(M=8, Ks=16).fit(X[:500], iter=2))
    je.topk_recall = None
    je.add_configure(X, nlist=20, iter=2)
    te = engine_from_arrays(je.codewords, je.codes, je.coarse_centers,
                            je._assignments(), device="cpu")
    te.topk_recall = None
    kw = dict(topk=5, reps=1, gt_ids=np.arange(16), method="linear")
    oj = jprof.benchmark_queries(je, X[:16], **kw)
    ot = benchmark_queries(te, X[:16], **kw)
    assert set(oj) == set(ot)
    assert (oj["recall@1"], oj["recall@5"]) == (ot["recall@1"], ot["recall@5"])


def test_trace_writes_profile(tmp_path):
    e, X = _engine()
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        e.query_batch(X[:4], topk=3)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("query" in str(ev.get("name", "")) or ev.get("ph") == "X"
               for ev in events)
