"""The readers of the program's spans (``metrics/_spans.py`` and the
``engine_*_ms``, ``ivf_*_ms``, ``union_rows`` and ``ivf_fallback``
readers) on a synthetic trace and synthetic records: each call placed
through its ``rii.clock`` mark, the slice's [lo, hi] kept, None where
there is nothing to read, device-busy time taken off the download."""

import pytest

import rii_tpu_torch.utils.profiling as prof
from portbench.harness.spec import Bench
from portbench.harness.trace import Trace

Span = prof.Span

NEW = ["engine_prep_ms.batch", "engine_prep_ms.pq", "engine_issue_ms.batch",
       "engine_issue_ms.pq", "engine_finish_ms.batch", "engine_finish_ms.pq",
       "ivf_probe_ms.pq", "ivf_select_ms.pq", "union_rows.pq",
       "ivf_fallback.pq"]


def _trace(marks, kernels=(), lo=0.0, hi=10_000.0):
    """A Trace of the slice [lo, hi] (microseconds) whose host operations
    are the ``rii.clock`` marks (start, end) and whose device ran
    ``kernels`` (start, end)."""
    t = Trace.__new__(Trace)
    t.n, t.d, t.m, t.stats = 1, 1, 1, {}
    t.kernels = [("k", a, b) for a, b in kernels]
    t.host_ops = [("aten::op", 0.0, 1.0)] + [("rii.clock", a, b)
                                             for a, b in marks]
    t.lo, t.hi = lo, hi
    t.calls, t.unions = [], []
    return t


def _call(cid, clock_ns, start_ns, stages, **attrs):
    """Records of one call: stages [(name, start ns, end ns, attrs)] that
    follow one another from ``start_ns``; the root ends with the last."""
    out = [Span(cid, cid * 100 + k, cid, name, a, b, dict(at))
           for k, (name, a, b, at) in enumerate(stages, 1)]
    out.append(Span(cid, cid, None, "rii.query_batch", start_ns,
                    stages[-1][2], dict(attrs, clock_ns=clock_ns)))
    return out


# the program's clock runs 5,000,000 ns ahead of the profiler's 0 us:
# clock_ns c sits at c / 1e3 - 5000 us
CALL_A = _call(1, 5_100_000, 5_090_000, [
    ("rii.prepare", 5_100_000, 5_150_000, {}),
    ("rii.upload", 5_150_000, 5_200_000, {}),
    ("rii.probe", 5_200_000, 5_300_000, {"device_ms": 0.4}),
    ("rii.scan", 5_300_000, 5_500_000, {}),
    ("rii.select", 5_500_000, 5_600_000, {"device_ms": 0.25}),
    ("rii.download", 5_600_000, 5_900_000, {})],
    route="ivf", queries=4, union_rows=400)
CALL_B = _call(2, 6_100_000, 6_090_000, [
    ("rii.prepare", 6_100_000, 6_120_000, {}),
    ("rii.upload", 6_120_000, 6_180_000, {}),
    ("rii.prepare", 6_180_000, 6_200_000, {}),
    ("rii.scan", 6_200_000, 6_400_000, {}),
    ("rii.download", 6_400_000, 6_500_000, {})],
    route="ivf_to_linear", queries=4)
# marks around each call's clock: midpoints 100 us and 1100 us
MARKS = [(98.0, 102.0), (1098.0, 1102.0)]


@pytest.fixture
def records(monkeypatch):
    recs = []
    monkeypatch.setattr(prof, "spans", lambda: list(recs))
    return recs


@pytest.fixture(scope="module")
def bench():
    return Bench()


def _read(bench, name, t):
    return bench.reader(name)(t)


def test_every_new_metric_has_a_reader_and_an_entry(bench):
    names = {m["name"] for m in bench.spec["per_layer"]}
    for name in NEW:
        assert name in names and callable(bench.reader(name))


def test_calls_are_placed_through_their_marks(records, bench):
    records += CALL_A + CALL_B
    t = _trace(MARKS)
    # A: prepare + upload 100 us; B: prepare + upload + prepare 100 us
    assert _read(bench, "engine_prep_ms.batch", t) == pytest.approx(0.1)
    # A: probe + scan + select 400 us; B: scan 200 us
    assert _read(bench, "engine_issue_ms.pq", t) == pytest.approx(0.3)
    # no kernel ran: download 300 us and 100 us
    assert _read(bench, "engine_finish_ms.batch", t) == pytest.approx(0.2)
    assert _read(bench, "ivf_probe_ms.pq", t) == pytest.approx(0.4)
    assert _read(bench, "ivf_select_ms.pq", t) == pytest.approx(0.25)
    assert _read(bench, "union_rows.pq", t) == pytest.approx(100.0)
    assert _read(bench, "ivf_fallback.pq", t) == pytest.approx(0.5)


def test_the_mark_sets_each_calls_place(records):
    from portbench.metrics._spans import calls
    records += CALL_A + CALL_B
    # B's mark 10 us later than the common clock would put it
    cs = calls(_trace([MARKS[0], (1108.0, 1112.0)]))
    assert [c.attrs["route"] for c in cs] == ["ivf", "ivf_to_linear"]
    assert cs[0].start == pytest.approx(90.0)
    assert cs[0].end == pytest.approx(900.0)
    assert cs[1].start == pytest.approx(1100.0)
    assert cs[1].stages["rii.download"][0][:2] == pytest.approx(
        (1410.0, 1510.0))


def test_only_calls_inside_the_slice(records, bench):
    records += CALL_A + CALL_B
    # the slice starts after A's root opens: only B is read
    t = _trace(MARKS, lo=95.0)
    assert _read(bench, "ivf_fallback.pq", t) == 1.0
    assert _read(bench, "engine_issue_ms.batch", t) == pytest.approx(0.2)
    assert _read(bench, "ivf_probe_ms.pq", t) is None
    assert _read(bench, "union_rows.pq", t) is None
    # the slice ends inside B
    t = _trace(MARKS, hi=1200.0)
    assert _read(bench, "ivf_fallback.pq", t) == 0.0


def test_older_records_without_a_mark_are_left_out(records, bench):
    """Roots of an earlier profile (no mark of this slice) are paired
    away: marks and roots are matched from the last."""
    old = _call(9, 1_000_000, 990_000, [
        ("rii.prepare", 1_000_000, 1_900_000, {})], route="linear",
        queries=4)
    records += old + CALL_A + CALL_B
    t = _trace(MARKS)
    assert _read(bench, "engine_prep_ms.batch", t) == pytest.approx(0.1)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_is_none(records, bench, name):
    assert _read(bench, name, _trace(MARKS)) is None
    records += CALL_A + CALL_B
    assert _read(bench, name, _trace([])) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_recorder_reads_none(monkeypatch, bench, name):
    """The parent commit's program has no ``spans``: the readers give None
    and do not raise."""
    monkeypatch.delattr(prof, "spans")
    assert _read(bench, name, _trace(MARKS)) is None


def test_finish_takes_the_device_busy_time_off(records, bench):
    records += CALL_A + CALL_B
    # A's download is [600, 900] us, B's [1400, 1500]: kernels busy 100 us
    # inside A's (two overlapping) and 30 us inside B's; one outside both
    kernels = [(650.0, 720.0), (700.0, 750.0), (1450.0, 1480.0),
               (1000.0, 1050.0)]
    t = _trace(MARKS, kernels=kernels)
    assert _read(bench, "engine_finish_ms.pq", t) == pytest.approx(
        ((300 - 100) + (100 - 30)) / 2 * 1e-3)


def test_busy_matches_the_traces_own():
    """The readers' one-merge busy time equals ``Trace.busy_us`` on
    overlapping, nested and touching kernels, for intervals that cut them."""
    import random

    from portbench.metrics._spans import busy_us

    rng = random.Random(5)
    kernels = []
    for _ in range(300):
        a = rng.uniform(0, 5000)
        kernels.append((a, a + rng.choice([0.0, 1.0, 7.5, 40.0, 300.0])))
    kernels += [(100.0, 200.0), (200.0, 250.0), (120.0, 130.0)]
    t = _trace([], kernels=kernels)
    for _ in range(200):
        a = rng.uniform(-100, 5200)
        b = a + rng.uniform(0, 800)
        assert busy_us(t, a, b) == pytest.approx(t.busy_us(a, b), abs=1e-9)
