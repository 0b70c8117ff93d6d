"""The ``ivf_tile_decodes.pq`` reader on synthetic records (the pattern of
``test_portbench_tile_fused.py``): the mean of the roots' ``tile_decodes``
counter over the slice's calls that ran kernel D, None where no call
carries it or the program has no recorder."""

import pytest

import rii_tpu_torch.utils.profiling as prof
from portbench.harness.spec import Bench
from portbench.tests.test_portbench_select_kernel import MARKS, _root, _trace

NAME = "ivf_tile_decodes.pq"


@pytest.fixture
def records(monkeypatch):
    recs = []
    monkeypatch.setattr(prof, "spans", lambda: list(recs))
    return recs


@pytest.fixture(scope="module")
def reader():
    bench = Bench()
    entry = {m["name"]: m for m in bench.spec["per_layer"]}[NAME]
    assert entry["moves"] == "qps.pq" and entry["unit"] == "decodes/tile"
    assert entry["layer"] == "kernels" and entry["better"] == "lower"
    assert entry["source"] == "program_counter"
    assert entry["workloads"] == ["sift1b_m8_shard.bulk"]
    return bench.reader(NAME)


def test_mean_over_the_calls_that_ran_kernel_d(records, reader):
    records += (_root(1, 5_100_000, route="ivf", tile_decodes=1)
                + _root(2, 6_100_000, route="ivf_to_linear")
                + _root(3, 7_100_000, route="ivf", tile_decodes=4))
    assert reader(_trace(MARKS)) == pytest.approx(2.5)
    # the slice starts after the first call
    assert reader(_trace(MARKS, lo=95.0)) == pytest.approx(4.0)


def test_nothing_to_read_is_none(records, reader):
    assert reader(_trace(MARKS)) is None
    records += _root(2, 6_100_000, route="ivf", tile_fused=1)
    assert reader(_trace(MARKS)) is None  # a program without the counter


def test_a_program_without_the_recorder_reads_none(monkeypatch, reader):
    monkeypatch.delattr(prof, "spans")
    assert reader(_trace(MARKS)) is None
