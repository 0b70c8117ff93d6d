"""The ``ivf_select_kernel.pq`` reader on synthetic records (the pattern of
``test_portbench_spans.py``): the mean of the roots' ``select_kernel``
counter over the slice's calls that ran the union, None where no call
carries it or the program has no recorder; and the program's own counter,
recorded under an active profiler, read back through the harness."""

import pytest

import rii_tpu_torch.utils.profiling as prof
from portbench.harness.spec import Bench
from portbench.harness.trace import Trace

Span = prof.Span
NAME = "ivf_select_kernel.pq"


def _trace(marks, lo=0.0, hi=10_000.0):
    t = Trace.__new__(Trace)
    t.n, t.d, t.m, t.stats = 1, 1, 1, {}
    t.kernels = []
    t.host_ops = [("rii.clock", a, b) for a, b in marks]
    t.lo, t.hi = lo, hi
    t.calls, t.unions = [], []
    return t


def _root(cid, clock_ns, **attrs):
    """A call of one stage whose root opens 10 us before its clock."""
    start = clock_ns - 10_000
    return [Span(cid, cid * 100 + 1, cid, "rii.scan", start, start + 50_000,
                 {}),
            Span(cid, cid, None, "rii.query_batch", start, start + 50_000,
                 dict(attrs, clock_ns=clock_ns))]


# the program's clock runs 5,000,000 ns ahead of the profiler's 0 us
MARKS = [(98.0, 102.0), (1098.0, 1102.0), (2098.0, 2102.0)]


@pytest.fixture
def records(monkeypatch):
    recs = []
    monkeypatch.setattr(prof, "spans", lambda: list(recs))
    return recs


@pytest.fixture(scope="module")
def reader():
    bench = Bench()
    entry = {m["name"]: m for m in bench.spec["per_layer"]}[NAME]
    assert entry["moves"] == "qps.pq"
    assert entry["layer"] == "IVF union and linear epilogue"
    assert entry["workloads"] == ["sift1b_m8_shard.bulk"]
    return bench.reader(NAME)


def test_mean_over_the_calls_that_ran_the_union(records, reader):
    records += (_root(1, 5_100_000, route="ivf", select_kernel=2)
                + _root(2, 6_100_000, route="ivf_to_linear")
                + _root(3, 7_100_000, route="ivf", select_kernel=1))
    assert reader(_trace(MARKS)) == pytest.approx(1.5)
    # the slice starts after the first call
    assert reader(_trace(MARKS, lo=95.0)) == pytest.approx(1.0)


def test_nothing_to_read_is_none(records, reader):
    assert reader(_trace(MARKS)) is None
    records += _root(2, 6_100_000, route="linear")
    assert reader(_trace(MARKS)) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch, reader):
    monkeypatch.delattr(prof, "spans")
    assert reader(_trace(MARKS)) is None


def test_the_programs_counter_is_read(reader):
    """A CPU engine's IVF call under an active profiler: its root carries
    ``select_kernel`` (0: the CPU takes the selection's twin), which the
    reader returns once the call is placed in the slice."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from portbench.metrics._spans import calls
    from rii_tpu_torch import PQ, Rii

    x = np.random.RandomState(0).random((6000, 32)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=16, device="cpu").fit(x[:500], iter=2))
    e.add_configure(x, nlist=40, iter=2)
    e.query_batch(x[:1], topk=3)
    q = x[np.asarray(e.posting_lists[5][:1])]
    with profile(activities=[ProfilerActivity.CPU]) as p:
        e.query_batch(q, topk=10, method="ivf", L=e.L0)
    marks = [(ev.time_range.start, ev.time_range.end) for ev in p.events()
             if ev.name == "rii.clock"]
    assert marks
    lo = min(a for a, _ in marks) - 1e6
    t = _trace(marks, lo=lo, hi=max(b for _, b in marks) + 1e6)
    got = calls(t)
    assert got and got[-1].attrs["route"] == "ivf"
    assert got[-1].attrs["select_kernel"] == 0
    assert reader(t) == 0.0
