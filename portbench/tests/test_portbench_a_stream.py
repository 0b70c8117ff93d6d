"""``scan_roofline`` on kernel A's streamed-query instantiation, the scan of
``gist1m_m8.bulk`` (D=960), on synthetic traces as
``test_portbench_spans.py`` builds them: the instantiation is layout 0
whatever its further template arguments, and its bound at D=960 is set by
operations."""

import pytest

from portbench.harness.spec import Bench
from portbench.reference import roofline
from portbench.tests.test_portbench_spans import _trace

N, D, M = 1_000_000, 960, 8


def _kernel(layout, out, mt, qs, element, *more):
    """The profiler's demangled name of an instantiation of
    ``tc_scan_kernel<layout, out, mt, qs, element, ...>``
    (csrc/replica_tc.cu), with any further template arguments."""
    args = ", ".join(str(a) for a in (layout, out, mt, qs, element) + more)
    return (f"void (anonymous namespace)::tc_scan_kernel<{args}>"
            "(CUtensorMap_st, CUtensorMap_st, unsigned short const*, ...)")


A_STREAM = _kernel(0, 0, 1, "true", "unsigned short")
A_STREAM6 = _kernel(0, 0, 1, "true", "unsigned short", "false")
D_STREAM = _kernel(5, 4, 1, "true", "unsigned short", "false")
MBTOPK = "void at::native::mbtopk::gatherTopK<float, unsigned int, 2>(...)"


@pytest.fixture(scope="module")
def bench():
    return Bench()


def _kernel_trace(calls, kernels):
    t = _trace([])
    t.n, t.d, t.m = N, D, M
    t.calls = calls
    t.kernels = kernels
    return t


def _bound_us(q):
    return roofline.scan_bound("bf16", q, N, D, M)[0] * 1e6


def test_the_cell_reads_the_scan_roofline(bench):
    """The D=960 cell is one of ``scan_roofline.batch``'s cells, and the
    cell reports the end-to-end metric that it moves."""
    by_name = {m["name"]: m for m in bench.spec["per_layer"]}
    entry = by_name["scan_roofline.batch"]
    assert "gist1m_m8.bulk" in entry["workloads"]
    qps = {m["name"]: m for m in bench.spec["end_to_end"]}[entry["moves"]]
    assert "gist1m_m8.bulk" in qps["workloads"]


def test_the_bound_is_set_by_operations():
    """At Q=1000 over 10^6 rows of D=960 the scan is bound by its 1.92
    TFLOP (1.94 ms at the bf16 peak), not by its 1.92 GB (0.57 ms)."""
    sec, by = roofline.scan_bound("bf16", 1000, N, D, M)
    assert by == "operations"
    assert sec == pytest.approx(2 * 1000 * N * D / 989e12)


@pytest.mark.parametrize("name", [A_STREAM, A_STREAM6],
                         ids=["five_args", "six_args"])
def test_scan_roofline_counts_the_streamed_instantiation(bench, name):
    """Two calls of Q=1000, each A's streamed instantiation and the merge:
    the merge is not counted."""
    calls = [(0.0, 10_000.0, 1000), (20_000.0, 30_000.0, 1000)]
    kernels = [(name, 100.0, 3_600.0), (MBTOPK, 3_700.0, 3_900.0),
               (name, 20_100.0, 24_100.0), (MBTOPK, 24_200.0, 24_400.0)]
    t = _kernel_trace(calls, kernels)
    want = 100.0 * 2 * _bound_us(1000) / (3_500.0 + 4_000.0)
    assert bench.reader("scan_roofline.batch")(t) == pytest.approx(want)


def test_scan_roofline_skips_a_call_of_another_layout(bench):
    """A call whose scan ran kernel D (layout 5) with no union recorded is
    not counted beside A's."""
    calls = [(0.0, 10_000.0, 1000), (20_000.0, 30_000.0, 512)]
    kernels = [(A_STREAM6, 100.0, 3_600.0), (D_STREAM, 20_100.0, 21_100.0)]
    t = _kernel_trace(calls, kernels)
    want = 100.0 * _bound_us(1000) / 3_500.0
    assert bench.reader("scan_roofline.batch")(t) == pytest.approx(want)
