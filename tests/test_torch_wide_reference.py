"""Kernel A's streamed-query path at GIST's width (D=960) through
``Rii.query_batch`` (A's plain twin over the (D, cap) bf16 replica, the
merge over its packed keys, the exact float32 rescore where the route
takes it) held to the benchmark's plain reference,
``portbench/reference/exact.py`` (plain torch: float64 ADC, the exhaustive
search over the codes), on the CPU at a small size of the benchmark's data
generator.

Both routes that reach the bf16 replica are run: ``linear`` (batches of 64
queries, rescored) and ``ivf_to_linear`` (a batch of 512 queries whose
union covers the index, not rescored: the distances are the bf16 products
with float32 sums). The engine takes the card's routes through the twins
(``force_kernel_routing``); ``scan_mode="bf16"`` puts its cache on the
transposed bf16 replica, which kernel A scans with the queries streamed
through its ring past 512 dims."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rii_tpu_torch.ops.hopper_scan as HS
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

N, D, M, KS, NLIST, TOPK = 4096, 960, 8, 16, 32, 5
QN = 512
# the benchmark's generator at GIST's width; sigma 0.1 over 256 modes keeps
# a query's nearest rows apart by more than bf16's rounding, so that what
# the selection loses by design stays small beside a fault
DATA = {"dim": D, "modes": 256, "sigma": 0.1, "zipf": 1.0,
        "chunk_rows": 4096}
# The rescored route returns ||x||^2 - 2 q.x + ||q||^2 in float32 from the
# codes: over D=960 its rounding is a few units of 2^-24 (6e-8) of the terms
# it cancels down from, ||q||^2 + ||x||^2 (measured: 3.1e-7 to 5.3e-7 of
# them over four sets of 512 queries); 2e-6 leaves room above that. The
# bf16 scores, returned without the rescore, miss by 2.3e-4 or more.
DIST_TOL_EXACT = 2e-6
# The route that does not rescore returns A's score: the query and each row
# rounded to bf16 (8 bits, 2^-9 of each element), the products summed in
# float32 and the low 7 bits of the key's mantissa given to the slot. The
# rounding of 960 such products reads 2.3e-4 to 3.1e-4 of the terms
# (measured as above); with the rows rounded to fp8 (e4m3, 4 bits) it
# reads 3.1e-3 to 4.2e-3. 1e-3 lies between, with room on both sides.
DIST_TOL_BF16 = 1e-3
# The selection keeps one candidate a 128-slot tile (A's packed keys) of the
# 32 tiles here: it loses a neighbour where two of a query's top 5 share a
# tile or bf16 rounding reorders the tiles (the linear route rescores the
# best max(2 * topk, topk + 8) tiles' minima). Over the 512 queries here
# (linear / ivf_to_linear): 0.042 / 0.054; rows rounded to fp8 0.146 /
# 0.187; half the index scanned 0.140 / 0.151. Over four other sets of 512
# queries: 0.009-0.088 a batch of 64 and 0.038-0.067 at Q=512, against
# fp8 rows' 0.125-0.159 and 0.18-0.23.
SEL_MISS_MAX = 0.1
ROUTES = {"linear": (64, dict(method="linear")),
          "ivf_to_linear": (QN, dict(method="ivf"))}


def _engine(dim, modes, sigma):
    mix = Mixture(dict(DATA, dim=dim, modes=modes, sigma=sigma), 20110101,
                  "cpu")
    pq = PQ(M=M, Ks=KS, device="cpu").fit(
        mix.take("learn", 4096).numpy(), iter=5)
    e = Rii(pq)
    e.scan_mode = "bf16"
    e.force_kernel_routing = True
    e.add_configure(mix.take("base", N).numpy(), nlist=NLIST, iter=3)
    return e, mix.take("query", QN)


@pytest.fixture(scope="module")
def setup():
    e, queries = _engine(D, DATA["modes"], DATA["sigma"])
    lin = e._ensure_cache()[0]
    assert lin.tier == "bf16" and lin.form == "decoded_t"
    # past 8 chunks of 64 dims kernel A streams the queries through its ring
    assert lin.replica.shape == (D, lin.cap) and D > 8 * 64
    return e, queries


def _query(e, queries, route):
    """The route's batches over the ``QN`` queries, each one
    ``query_batch`` under a CPU profiler. Returns (ids, dists, the calls'
    root spans)."""
    qn, kw = ROUTES[route]
    ids, dists, roots = [], [], []
    for s in range(0, QN, qn):
        before = {r.id for r in P.spans()}
        with profile(activities=[ProfilerActivity.CPU]):
            i, d = e.query_batch(queries[s:s + qn].numpy(), topk=TOPK,
                                 L=4 * e.L0, **kw)
        new = [r for r in P.spans() if r.id not in before and r.parent is None]
        assert len(new) == 1
        ids.append(i)
        dists.append(d)
        roots += new
    return np.concatenate(ids), np.concatenate(dists), roots


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


def _tol(route):
    return DIST_TOL_EXACT if route == "linear" else DIST_TOL_BF16


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_wide_scan_holds_to_the_reference(setup, route):
    e, queries = setup
    ids, d, roots = _query(e, queries, route)
    for r in roots:
        assert r.attrs["route"] == route and r.attrs["tier"] == "bf16"
    bad, gap, miss = _numbers(e, queries, ids, d)
    assert bad == 0
    assert gap <= _tol(route), gap
    assert miss <= SEL_MISS_MAX, miss


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fp8_rows_fail_the_check(setup, monkeypatch, route):
    """The replica's rows rounded to fp8 (e4m3), a precision below the
    configuration's bf16: the route that returns A's scores misses in its
    distances, the rescored one in its selection."""
    e, queries = setup
    lin = e._ensure_cache()[0]
    monkeypatch.setattr(lin, "replica", lin.replica.to(
        torch.float8_e4m3fn).to(torch.bfloat16))
    ids, d, _ = _query(e, queries, route)
    bad, gap, miss = _numbers(e, queries, ids, d)
    assert bad == 0
    if route == "linear":
        assert gap <= DIST_TOL_EXACT and miss > SEL_MISS_MAX, (gap, miss)
    else:
        assert gap > DIST_TOL_BF16, gap


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_half_the_index_fails_the_check(setup, monkeypatch, route):
    """The planted fault: the rows past N/2 masked out of the scan."""
    e, queries = setup
    lin = e._ensure_cache()[0]
    norms = lin.norms_flat.clone()
    norms[N // 2:] = float("inf")
    monkeypatch.setattr(lin, "norms_flat", norms)
    ids, d, _ = _query(e, queries, route)
    bad, gap, miss = _numbers(e, queries, ids, d)
    assert bad == 0 and gap <= _tol(route)
    assert miss > SEL_MISS_MAX, miss


def test_a_skipped_rescore_fails_the_check(setup, monkeypatch):
    """The planted fault on the linear route: the merge's bf16 distances
    and ids returned in place of the exact rescore's."""
    e, queries = setup
    merged = {}
    real = HS._merge_packed_keys

    def merge(q, keys, k):
        merged["out"] = real(q, keys, k)
        return merged["out"]

    def no_rescore(q, ids_a, codes, codewords, norms, topk):
        d, i = merged["out"]
        return d[:, :topk], i[:, :topk]

    monkeypatch.setattr(HS, "_merge_packed_keys", merge)
    monkeypatch.setattr(HS, "_exact_rescore_codes", no_rescore)
    ids, d, _ = _query(e, queries, "linear")
    _, gap, _ = _numbers(e, queries, ids, d)
    assert gap > 100 * DIST_TOL_EXACT, gap


def test_a_ragged_batch_answers_as_its_padded_batch(setup):
    """A batch of 300 queries (padded to 512, no rescore, as the
    benchmark's 1,000 are padded to 1,024) answers each query as the
    batch of 512 does, and holds to the reference."""
    e, queries = setup
    kw = dict(topk=TOPK, L=4 * e.L0, method="ivf")
    ids, d = e.query_batch(queries[:300].numpy(), **kw)
    ids512, d512 = e.query_batch(queries.numpy(), **kw)
    assert np.array_equal(ids, ids512[:300]) and np.array_equal(d, d512[:300])
    bad, gap, miss = _numbers(e, queries, ids, d)
    assert bad == 0 and gap <= DIST_TOL_BF16 and miss <= SEL_MISS_MAX
