"""The ``upload_staged.batch`` reader on synthetic records (the pattern of
``test_portbench_tile_fused.py``): the mean of the roots' ``upload_staged``
counter over the slice's calls that carry it, None where no call carries it
or the program has no recorder."""

import pytest

import rii_tpu_torch.utils.profiling as prof
from portbench.harness.spec import Bench
from portbench.tests.test_portbench_select_kernel import MARKS, _root, _trace

NAME = "upload_staged.batch"
CELLS = ["sift1m_m64.bulk", "sift1m_m64.subset", "bigann10m_m32.bulk",
         "gist1m_m8.bulk"]


@pytest.fixture
def records(monkeypatch):
    recs = []
    monkeypatch.setattr(prof, "spans", lambda: list(recs))
    return recs


@pytest.fixture(scope="module")
def reader():
    bench = Bench()
    entry = {m["name"]: m for m in bench.spec["per_layer"]}[NAME]
    assert entry["moves"] == "qps" and entry["unit"] == "fraction"
    assert entry["layer"] == "engine" and entry["better"] == "higher"
    assert entry["source"] == "program_counter"
    assert entry["workloads"] == CELLS
    return bench.reader(NAME)


def test_every_staged_call_reads_one(records, reader):
    records += (_root(1, 5_100_000, route="ivf_to_linear", upload_staged=1)
                + _root(2, 6_100_000, route="ivf", upload_staged=1)
                + _root(3, 7_100_000, route="linear_masked", upload_staged=1))
    assert reader(_trace(MARKS)) == 1.0


def test_share_of_the_calls_that_carry_it(records, reader):
    records += (_root(1, 5_100_000, route="linear", upload_staged=1)
                + _root(2, 6_100_000, route="linear")
                + _root(3, 7_100_000, route="linear", upload_staged=0))
    assert reader(_trace(MARKS)) == pytest.approx(0.5)
    # the slice starts after the first call
    assert reader(_trace(MARKS, lo=95.0)) == pytest.approx(0.0)


def test_nothing_to_read_is_none(records, reader):
    assert reader(_trace(MARKS)) is None
    records += _root(2, 6_100_000, route="ivf", tile_fused=1)
    assert reader(_trace(MARKS)) is None  # a program without the counter


def test_a_program_without_the_recorder_reads_none(monkeypatch, reader):
    monkeypatch.delattr(prof, "spans")
    assert reader(_trace(MARKS)) is None
