"""The int8 tier's linear scan through ``Rii.query_batch`` (kernel F's
plain twin, the merge over its packed keys, the exact float32 rescore)
held to the benchmark's plain reference, ``portbench/reference/exact.py``
(plain torch: float64 ADC, the exhaustive search over the codes), on the
CPU at a small size of the benchmark's data generator.

Both routes that reach the int8 replica are run: ``linear`` and
``ivf_to_linear`` (a batch of 512 queries whose union covers the index).
The engine takes the card's routes through the twins
(``force_kernel_routing``); ``scan_mode="int8"`` puts its cache on the int8
replica."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rii_tpu_torch.ops.hopper_i8 as HI
import rii_tpu_torch.utils.profiling as P
from portbench.reference.datagen import Mixture
from portbench.reference.exact import (
    adc64,
    search,
    selection_miss,
    terms,
    widest_gap,
)
from rii_tpu_torch import PQ, Rii

N, D, M, KS, NLIST, TOPK = 16384, 16, 4, 256, 64, 5
# the benchmark's generator at a small size; sigma 0.1 over 256 modes keeps
# a query's nearest rows apart by more than the int8 selection's rounding,
# so that what the selection loses by design stays small beside a fault
DATA = {"dim": D, "modes": 256, "sigma": 0.1, "zipf": 1.0,
        "chunk_rows": 4096}
# A returned distance is ||x||^2 - 2 q.x + ||q||^2 in float32 over D=16:
# its rounding is a few units of 2^-24 (6e-8) of the terms it cancels down
# from, ||q||^2 + ||x||^2 (measured: at most 3.0e-7 of them); 1e-6 leaves
# room above that. Kernel F's int8 scores, returned without the rescore,
# miss by far more.
DIST_TOL = 1e-6
# The selection keeps one candidate a 128-slot tile (F's packed keys, int8
# scores) and rescores the best 2 * topk tiles' minima: it loses a
# neighbour where two of a query's top 5 share a tile or int8 rounding
# reorders the tiles. Measured over four sets of 512 queries of this data:
# 0.022-0.039 (both routes); the fault k_fetch = topk (no overfetch) reads
# 0.16-0.20 and half the index scanned 0.49.
SEL_MISS_MAX = 0.1
ROUTES = {"linear": (64, dict(method="linear")),
          "ivf_to_linear": (512, dict(method="ivf"))}


@pytest.fixture(scope="module")
def setup():
    mix = Mixture(DATA, 20180503, "cpu")
    base = mix.take("base", N)
    queries = mix.take("query", 512)
    pq = PQ(M=M, Ks=KS, device="cpu").fit(
        mix.take("learn", 4096).numpy(), iter=5)
    e = Rii(pq)
    e.scan_mode = "int8"
    e.force_kernel_routing = True
    e.add_configure(base.numpy(), nlist=NLIST, iter=3)
    lin = e._ensure_cache()[0]
    assert lin.tier == "int8" and lin.form == "decoded_i8"
    return e, queries


def _query(e, queries, route):
    """One ``query_batch`` of the route's batch under a CPU profiler.
    Returns (ids, dists, the call's root span, its stages in order)."""
    qn, kw = ROUTES[route]
    before = {s.id for s in P.spans()}
    with profile(activities=[ProfilerActivity.CPU]):
        ids, d = e.query_batch(queries[:qn].numpy(), topk=TOPK,
                               L=4 * e.L0, **kw)
    new = [s for s in P.spans() if s.id not in before]
    root = [s for s in new if s.parent is None]
    assert len(root) == 1
    kids = sorted((s for s in new if s.parent is not None),
                  key=lambda s: s.start_ns)
    return ids, d, root[0], kids


def _numbers(e, queries, ids, dists):
    """Structural faults, the widest gap of a returned distance from the
    float64 ADC of its id over ||q||^2 + ||x||^2, and the share of ids
    outside the exhaustive float64 ADC top k (ties counted in)."""
    q = queries[:len(ids)]
    codes = torch.as_tensor(e.codes)
    cw = torch.as_tensor(e.codewords)
    valid = torch.as_tensor((ids >= 0) & (ids < e.N))
    s = np.sort(ids, axis=1)
    bad = int(((ids < 0) | (ids >= e.N)).any(1).sum()
              + (s[:, 1:] == s[:, :-1]).any(1).sum()
              + (np.diff(dists, axis=1) < 0).any(1).sum())
    codes_q = codes[torch.as_tensor(np.clip(ids, 0, e.N - 1))]
    ref = adc64(q, codes_q, cw)
    gap = widest_gap(torch.as_tensor(dists), ref, valid,
                     terms(q, codes_q, cw))
    _, exh = search(q, [(0, codes)], cw, TOPK)
    return bad, gap, selection_miss(ref, exh[:, -1], valid)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_int8_linear_scan_holds_to_the_reference(setup, route):
    e, queries = setup
    ids, d, root, _ = _query(e, queries, route)
    assert root.attrs["route"] == route and root.attrs["tier"] == "int8"
    bad, gap, miss = _numbers(e, queries, ids, d)
    assert bad == 0
    assert gap <= DIST_TOL, gap
    assert miss <= SEL_MISS_MAX, miss


def _skip_rescore(monkeypatch):
    """The planted fault: the merge's int8 distances and ids returned in
    place of the exact rescore's."""
    merged = {}
    real = HI._merge_packed_keys

    def merge(queries, keys, k):
        merged["out"] = real(queries, keys, k)
        return merged["out"]

    def no_rescore(queries, ids_a, codes, codewords, norms, topk):
        d, i = merged["out"]
        return d[:, :topk], i[:, :topk]

    monkeypatch.setattr(HI, "_merge_packed_keys", merge)
    monkeypatch.setattr(HI, "_exact_rescore_codes", no_rescore)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_skipped_rescore_fails_the_check(setup, monkeypatch, route):
    e, queries = setup
    _skip_rescore(monkeypatch)
    ids, d, root, _ = _query(e, queries, route)
    assert root.attrs["tier"] == "int8"
    _, gap, _ = _numbers(e, queries, ids, d)
    assert gap > 100 * DIST_TOL, gap


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_no_overfetch_fails_the_check(setup, monkeypatch, route):
    """The planted fault k_fetch = topk: the rescore sees only the best
    topk tiles' minima."""
    e, queries = setup
    real = HI._merge_packed_keys
    monkeypatch.setattr(HI, "_merge_packed_keys",
                        lambda q, keys, k: real(q, keys, TOPK))
    ids, d, _, _ = _query(e, queries, route)
    bad, gap, miss = _numbers(e, queries, ids, d)
    assert bad == 0 and gap <= DIST_TOL
    assert miss > SEL_MISS_MAX, miss


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_root_carries_the_tier_and_the_select_stage(setup, route):
    """Kernel F stays under ``rii.scan``; the merge, the rescore and the
    ids run under the int8 wrapper's ``rii.select``, the stage before the
    download."""
    e, queries = setup
    _, _, root, kids = _query(e, queries, route)
    names = [s.name for s in kids]
    assert root.attrs["tier"] == "int8"
    assert names[-3:] == ["rii.scan", "rii.select", "rii.download"]
    assert "rii.probe" not in names and "union_rows" not in root.attrs


def test_the_tier_counter_names_the_caches_tier(setup):
    """A pq-tier engine over the same codes notes ``pq``."""
    e, queries = setup
    other = Rii(PQ.from_codewords(e.codewords, device="cpu"))
    other.add_configure(
        Mixture(DATA, 20180503, "cpu").take("base", 4096).numpy(),
        nlist=16, iter=2)
    for method in ("linear", "ivf"):
        with profile(activities=[ProfilerActivity.CPU]):
            before = {s.id for s in P.spans()}
            other.query_batch(queries[:4].numpy(), topk=TOPK, method=method)
        roots = [s for s in P.spans()
                 if s.id not in before and s.parent is None]
        assert [r.attrs["tier"] for r in roots] == ["pq"]
