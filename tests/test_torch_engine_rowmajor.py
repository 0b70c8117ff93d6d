"""The engine's route to the row-major bf16 scan (kernel H, the port of K11)
against rii_tpu's.

A cache built in exact mode (``topk_recall=None`` at the first query after
a mutation) holds the row-major ``decoded_flat`` replica, and setting
``topk_recall`` afterwards does not rebuild it. rii_tpu then scans it with
``replica_scan_topk`` (rii_tpu/rii.py ``_query_linear_batch``): one
candidate per 128-slot tile, packed keys, and the exact float32 rescore
below Q=512. The port's engine (``force_kernel_routing`` on the CPU, so the
twin of kernel H) must answer as that call does on the JAX engine's own
``decoded_flat``, ``norms_flat``, ``codes_flat`` and ``codewords``. The JAX
engine's ``query_batch`` cannot be the oracle here: it passes no
``interpret`` to the Pallas kernel. The oracle merges with
``recall_target=None`` (its ``approx_max_k`` is not exact on the CPU) and
``packed=True`` (what ``recall_target=0.99`` selects).

D=64, M=8, Ks=32, topk=10; N=2000 (cap 2048, 16 tiles) for the full scan,
N=6000 (cap 8192) for a subset of 5000 ids. Tolerances: rescored distances
1e-5 relative (exact ADC summed in other orders), selection-only ones 1e-4
(the packed key's 2^-16 step at scores near 10); ids per rank except at
tied distances.

The same holds in the other direction for the pq windows (N=40,000,
nlist=200, ``scan_mode="pq"``): a cache built in exact mode has no kernel
route, and once ``topk_recall`` is set again rii_tpu's IVF runs its plain
union scan (it takes its window kernels only when the build set
``pallas_cw``); the port must too, not kernels D/E."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import rii_tpu
from rii_tpu.ops import pallas_scan as P
from rii_tpu_torch import PQ, Rii
from rii_tpu_torch import rii as port_rii

from _torch_parity import assert_ranked_ids_match

D, NLIST, TOPK = 64, 20, 10
RESCORE_RTOL = 1e-5
SELECT_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _engines(n):
    """The JAX and port engines on shared codewords and data, each with a
    cache built by a first query in exact mode, then set to fast mode."""
    rng = np.random.RandomState(5)
    x = rng.random((n, D)).astype(np.float32)
    jpq = rii_tpu.PQ(M=8, Ks=32).fit(x[:1024], iter=3)
    je = rii_tpu.Rii(jpq)
    te = Rii(PQ.from_codewords(jpq.codewords, device="cpu"))
    te.force_kernel_routing = True
    for e in (je, te):
        e.scan_mode = "bf16"
        e.topk_recall = None
        e.add_configure(x, nlist=NLIST, iter=3)
        e.query_batch(x[:2], topk=TOPK, method="linear")  # builds the cache
        e.topk_recall = 0.99
    q = (x[rng.choice(n, 512, replace=False)]
         + rng.normal(0, 0.01, (512, D))).astype(np.float32)
    return je, te, q, rng


def _oracle(je, q, tids=None, rescore=True):
    """rii_tpu's K11 route on its engine's arrays, in interpret mode."""
    dc = je._ensure_cache()
    norms = np.asarray(dc["norms_flat"]).copy()
    if tids is not None:
        mask = np.zeros(dc["cap"], bool)
        mask[tids] = True
        norms[~mask] = np.inf
    kw = dict(codes=dc["codes_flat"], codewords=dc["codewords"]) if rescore else {}
    d, i = P.replica_scan_topk(jnp.asarray(q), dc["decoded_flat"],
                               jnp.asarray(norms[:, None]), topk=TOPK,
                               blk=min(8192, dc["cap"]), interpret=True,
                               recall_target=None, packed=True, **kw)
    return np.asarray(i), np.asarray(d)


@pytest.fixture
def h_calls(monkeypatch):
    """Counts the engine's calls of the port's replica_scan_topk."""
    calls = []
    real = port_rii.replica_scan_topk

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(port_rii, "replica_scan_topk", counted)
    return calls


def test_exact_first_query_keeps_the_rowmajor_replica():
    je, te, _, _ = _engines(2000)
    for e in (je, te):
        dc = e._ensure_cache()
        assert dc["mode"] == "bf16" and "decoded_flat" in dc
        assert "decoded_t" not in dc
    np.testing.assert_array_equal(
        np.asarray(je._ensure_cache()["decoded_flat"].astype(jnp.float32)),
        te._ensure_cache()["decoded_flat"].float().numpy())


@pytest.mark.parametrize("qn,rtol", [(16, RESCORE_RTOL), (512, SELECT_RTOL)],
                         ids=["Q16-rescored", "Q512-selection"])
def test_fast_mode_takes_the_k11_route(h_calls, qn, rtol):
    """Q=16 rescores exactly (the engine's "auto" policy below Q=512),
    Q=512 returns the selection's key-precision distances."""
    je, te, q, _ = _engines(2000)
    ids, dists = te.query_batch(q[:qn], topk=TOPK, method="linear")
    i_j, d_j = _oracle(je, q[:qn], rescore=qn < 512)
    assert_ranked_ids_match(ids, dists, i_j, d_j, rtol=rtol)
    assert h_calls == [qn]


PQ_N, PQ_NLIST = 40_000, 200


@functools.lru_cache(maxsize=None)
def _pq_engines(exact_build):
    """Both packages at scan_mode="pq" (pq windows), their cache built by a
    first linear query in exact mode or in fast mode, then set to fast
    mode: rii_tpu through Pallas interpret mode, the port on its kernel
    routes through the twins."""
    rng = np.random.RandomState(5)
    x = rng.random((PQ_N, D)).astype(np.float32)
    jpq = rii_tpu.PQ(M=8, Ks=32).fit(x[:1024], iter=3)
    je = rii_tpu.Rii(jpq)
    je.pallas_interpret = True
    te = Rii(PQ.from_codewords(jpq.codewords, device="cpu"))
    te.force_kernel_routing = True
    for e in (je, te):
        e.scan_mode = "pq"
        e.topk_recall = None if exact_build else 0.99
        e.add_configure(x, nlist=PQ_NLIST, iter=3)
        e.query_batch(x[:1], topk=TOPK, method="linear")  # builds the cache
        e.topk_recall = 0.99
    q = (x[rng.choice(PQ_N, 8, replace=False)]
         + rng.normal(0, 0.01, (8, D))).astype(np.float32)
    return je, te, q


@pytest.mark.parametrize("exact_build", [True, False],
                         ids=["exact-built", "fast-built"])
def test_pq_windows_take_kernels_d_e_only_on_a_kernel_route_cache(
        monkeypatch, exact_build):
    """A cache built in exact mode keeps its pq windows when topk_recall is
    set again, and IVF then runs the plain union scan, as rii_tpu does (it
    takes its window kernels only when the build set "pallas_cw"): ids per
    rank and distances within 1e-5 of rii_tpu's, kernels D and E untouched.
    A cache built in fast mode takes kernels D/E (their twins here) and
    answers in the bf16 class with rii_tpu's nearest neighbours."""
    import rii_tpu_torch.ops.hopper_pq as HP
    je, te, q = _pq_engines(exact_build)
    dc = te._ensure_cache()
    assert dc["mode"] == "pq" and dc["windows"] == "pq"
    assert dc["pq_kernel_route"] is not exact_build
    assert ("pallas_cw" in je._ensure_cache()) is not exact_build
    routes = []
    real = port_rii.ivf_union_scan_topk_pq

    def counted(*args, **kw):
        routes.append(kw["use_kernel"])
        return real(*args, **kw)

    monkeypatch.setattr(port_rii, "ivf_union_scan_topk_pq", counted)
    launches = (HP.ivf_dt_window_tile_minima.launches,
                HP.ivf_pq_window_tile_minima.launches)
    ij, dj = je.query_batch(q, topk=TOPK, L=100, method="ivf")
    it, dt = te.query_batch(q, topk=TOPK, L=100, method="ivf")
    assert routes == [not exact_build]  # one batch, kept off the linear scan
    assert (HP.ivf_dt_window_tile_minima.launches,
            HP.ivf_pq_window_tile_minima.launches) == launches
    if exact_build:
        assert_ranked_ids_match(it, dt, ij, dj, rtol=RESCORE_RTOL)
    else:
        np.testing.assert_allclose(dt, dj, rtol=3e-2, atol=3e-2)
        assert (it[:, 0] == ij[:, 0]).all()


def test_masked_subset_above_4096_takes_the_k11_route(h_calls):
    je, te, q, rng = _engines(6000)
    tids = np.sort(rng.choice(6000, 5000, replace=False)).astype(np.int64)
    ids, dists = te.query_batch(q[:16], topk=TOPK, target_ids=tids,
                                method="linear")
    assert np.isin(ids, tids).all()
    i_j, d_j = _oracle(je, q[:16], tids=tids)
    assert_ranked_ids_match(ids, dists, i_j, d_j, rtol=RESCORE_RTOL)
    assert h_calls == [16]


def test_small_subsets_and_exact_mode_stay_off_the_k11_route(h_calls):
    """Subsets of 4096 ids or fewer keep the subset scan, and exact mode
    keeps the exact scan of the replica; both answer as rii_tpu's engine."""
    je, te, q, rng = _engines(2000)
    tids = np.sort(rng.choice(2000, 500, replace=False)).astype(np.int64)
    for e in (je, te):
        e.topk_recall = None
    try:
        for sub in (None, tids):
            i_j, d_j = je.query_batch(q[:16], topk=TOPK, target_ids=sub,
                                      method="linear")
            i_t, d_t = te.query_batch(q[:16], topk=TOPK, target_ids=sub,
                                      method="linear")
            assert_ranked_ids_match(i_t, d_t, i_j, d_j, rtol=RESCORE_RTOL)
    finally:
        for e in (je, te):
            e.topk_recall = 0.99
    te.query_batch(q[:16], topk=TOPK, target_ids=tids, method="linear")
    assert h_calls == []
