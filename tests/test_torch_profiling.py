"""The port's profiling helpers (rii_tpu_torch.utils.profiling): the cases
of tests/test_profiling.py on a CPU engine, then the engine's spans and
counters under a CPU profiler. Times here are the host's; only their signs,
order and keys are checked."""

import collections
import json
import os

import numpy as np
import pytest
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import rii_tpu
import rii_tpu.utils.profiling as jprof
import rii_tpu_torch.utils.profiling as P
from rii_tpu_torch import PQ, QueryServer, Rii
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


# -- the engine's spans and counters (utils.profiling's recorder) --------

STAGES = {"rii.prepare", "rii.upload", "rii.probe", "rii.scan",
          "rii.select", "rii.download"}


@pytest.fixture(scope="module")
def span_engine():
    """N=6000 over 40 lists: a one-query IVF batch probes few enough windows
    to stay off the linear scan, and a 5000-id subset takes the masked
    scan."""
    X = np.random.RandomState(0).random((6000, 32)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=16, device="cpu").fit(X[:500], iter=2))
    e.add_configure(X, nlist=40, iter=2)
    e.query_batch(X[:1], topk=3)  # the cache
    return e, X


def _recorded(fn):
    """Run ``fn`` under a CPU profiler; returns (the spans it recorded, the
    profiler)."""
    before = {s.id for s in P.spans()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [s for s in P.spans() if s.id not in before], prof


def _calls(records):
    """[(root, its children by start)] of ``records``, roots by start."""
    roots = sorted((s for s in records if s.parent is None),
                   key=lambda s: s.start_ns)
    return [(r, sorted((s for s in records if s.call == r.id and s is not r),
                       key=lambda s: s.start_ns)) for r in roots]


def _route_kwargs(e, route):
    pl0 = np.sort(np.asarray(e.posting_lists[0], dtype=np.int64))
    return {
        "linear": dict(method="linear"),
        "linear_subset_gather": dict(method="linear",
                                     target_ids=np.arange(100, dtype=np.int64)),
        "linear_masked": dict(method="linear",
                              target_ids=np.arange(5000, dtype=np.int64)),
        "ivf": dict(method="ivf", L=e.L0),
        "ivf_to_linear": dict(method="ivf", L=e.N),
        # 200 targets of list 0 for a query of list 5: the probed windows
        # hold fewer than topk of them, so the batch widens
        "ivf_widened": dict(method="ivf", L=10, target_ids=pl0[:200]),
    }[route]


def test_query_batch_records_nothing_without_a_profiler(span_engine):
    e, X = span_engine
    before, dropped = P.spans(), P.dropped_spans()
    e.query_batch(X[:4], topk=3)
    e.query_batch(X[:1], topk=3, method="ivf", L=e.L0)
    assert not P.recording()
    assert P.spans() == before and P.dropped_spans() == dropped


@pytest.mark.parametrize("route", ["linear", "linear_subset_gather",
                                   "linear_masked", "ivf", "ivf_to_linear",
                                   "ivf_widened"])
def test_query_batch_records_its_stages_and_route(span_engine, route):
    e, X = span_engine
    q = X[np.asarray(e.posting_lists[5][:1])]
    kw = _route_kwargs(e, route)
    out, _ = _recorded(lambda: e.query_batch(q, topk=10, **kw))
    calls = _calls(out)
    assert len(calls) == 1
    root, kids = calls[0]
    assert root.name == "rii.query_batch" and root.call == root.id
    assert root.attrs["route"] == route and root.attrs["queries"] == 1
    assert len(out) == 1 + len(kids)
    assert all(s.parent == root.id for s in kids)
    assert {s.name for s in kids} <= STAGES
    assert kids[0].name == "rii.prepare" and kids[-1].name == "rii.download"
    # the stages follow one another inside the root
    assert root.start_ns <= kids[0].start_ns
    assert kids[-1].end_ns == root.end_ns
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns == b.start_ns and a.name != b.name
    names = [s.name for s in kids]
    ivf_ran = route in ("ivf", "ivf_widened")
    assert ("rii.probe" in names) == ivf_ran
    assert ("rii.select" in names) == ivf_ran
    assert "rii.scan" in names
    assert ("union_rows" in root.attrs) == ivf_ran


def test_union_rows_counts_the_unions_live_rows(span_engine):
    """The pq union's plain branch (the CPU route): ``union_rows`` is the
    member count of the distinct probed windows, the probes recomputed here
    from the cache."""
    import torch

    e, X = span_engine
    q = X[np.asarray(e.posting_lists[5][:1])]
    out, _ = _recorded(lambda: e.query_batch(q, topk=10, method="ivf",
                                             L=e.L0))
    root = [s for s in out if s.parent is None][0]
    assert root.attrs["route"] == "ivf"
    win = e._ensure_cache()[1]
    assert win.tier == "pq" and not win.kernel_route
    wv = e._probe_width_virtual(e.L0, None, win)
    qt = torch.tensor(q)
    scores = win.centers_norms_v[None, :] - 2.0 * (
        qt.to(torch.bfloat16).float()
        @ win.centers_dec_v.to(torch.bfloat16).float().T)
    probes = torch.sort(scores, dim=1, stable=True).indices[:, :wv]
    windows = torch.unique(probes)
    assert root.attrs["union_rows"] == int(win.vlen_g[windows].sum())
    assert 0 < root.attrs["union_rows"] < e.N


def test_clock_mark_places_the_spans_on_the_profilers_timeline(span_engine):
    """Each root's ``rii.clock`` is a host-only event; through it the
    spans land inside the profiled interval that encloses the calls."""
    e, X = span_engine

    def calls():
        with record_function("test.window"):
            for k in range(3):
                e.query_batch(X[k:k + 2], topk=3)

    out, prof = _recorded(calls)
    events = list(prof.events())
    marks = sorted((ev for ev in events if ev.name == P.CLOCK_MARK),
                   key=lambda ev: ev.time_range.start)
    assert len(marks) == 3
    assert all(ev.device_type == DeviceType.CPU for ev in marks)
    window = [ev for ev in events if ev.name == "test.window"][0].time_range
    calls = _calls(out)
    assert len(calls) == 3
    for ev, (root, kids) in zip(marks, calls):
        off = 0.5 * (ev.time_range.start + ev.time_range.end) \
            - root.attrs["clock_ns"] * 1e-3
        for s in [root] + kids:
            assert window.start <= s.start_ns * 1e-3 + off
            assert s.end_ns * 1e-3 + off <= window.end


def test_query_server_spans_keep_their_calls_apart(span_engine):
    """Two dispatchers run ``query_batch`` at once: each child span sits in
    its own root's call, inside it, the stages one after another."""
    e, X = span_engine

    def serve():
        with QueryServer(e, max_batch=4, max_wait_ms=1, dispatchers=2) as srv:
            futs = [srv.submit(X[k], topk=3, method="linear")
                    for k in range(24)]
            for f in futs:
                f.result(timeout=60)

    out, _ = _recorded(serve)
    calls = _calls(out)
    assert len(calls) >= 6
    assert sum(len(k) for _, k in calls) + len(calls) == len(out)
    for root, kids in calls:
        assert [s.name for s in kids] == ["rii.prepare", "rii.upload",
                                          "rii.scan", "rii.download"]
        assert all(s.parent == root.id for s in kids)
        assert root.start_ns <= kids[0].start_ns
        assert kids[-1].end_ns == root.end_ns
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns == b.start_ns


def test_spans_of_many_threads_stay_with_their_calls(span_engine):
    """Twelve threads query at once with a very short switch interval:
    every call keeps its own four stages (a stage opened in another
    thread's call would break the sequence), none is lost."""
    import sys
    import threading

    e, X = span_engine
    n_threads, n_calls = 12, 4
    errors = []

    def worker(k):
        try:
            for j in range(n_calls):
                e.query_batch(X[k + j:k + j + 2], topk=3, method="linear")
        except Exception as ex:  # reported below
            errors.append(ex)

    def run():
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)

    dropped = P.dropped_spans()
    out, _ = _recorded(run)
    assert not errors
    calls = _calls(out)
    assert len(calls) == n_threads * n_calls
    assert len(out) == 5 * len(calls) and P.dropped_spans() == dropped
    for root, kids in calls:
        assert [s.name for s in kids] == ["rii.prepare", "rii.upload",
                                          "rii.scan", "rii.download"]
        assert root.attrs["queries"] == 2 and root.attrs["route"] == "linear"
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns == b.start_ns


def test_trace_writes_the_engines_spans(tmp_path, span_engine):
    e, X = span_engine
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        e.query_batch(X[:1], topk=3, method="ivf", L=e.L0)
        e.query_batch(X[:4], topk=3, method="linear")
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    ours = [ev for ev in events if ev.get("cat") == "rii"]
    roots = [ev for ev in ours if ev["name"] == "rii.query_batch"]
    assert len(roots) == 2
    assert {ev["args"]["route"] for ev in roots} == {"ivf", "linear"}
    assert {"rii.probe", "rii.scan", "rii.select", "rii.download"} <= {
        ev["name"] for ev in ours}
    for ev in ours:
        root = [r for r in roots if r["args"]["call"] == ev["args"]["call"]][0]
        assert ev["ph"] == "X" and ev["dur"] >= 0
        assert root["ts"] <= ev["ts"] + 1e-3
        assert ev["ts"] + ev["dur"] <= root["ts"] + root["dur"] + 1e-3


def test_full_ring_counts_its_drops(span_engine, monkeypatch):
    e, X = span_engine
    monkeypatch.setattr(P, "_ring", collections.deque(maxlen=4))
    dropped = P.dropped_spans()
    _recorded(lambda: e.query_batch(X[:2], topk=3, method="linear"))
    # a root and four stages into a ring of four
    assert P.dropped_spans() == dropped + 1
    assert len(P.spans()) == 4
