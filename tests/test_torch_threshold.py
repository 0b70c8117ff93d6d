"""The port's auto method selection (analytic threshold and the timed
calibration) and its stage statistics, against rii_tpu's.

The cases of tests/test_threshold.py on the port (the calibration's timings
are host times here, so only the fitted polynomial's shape is checked);
then ``last_reconfigure_stats`` and ``last_cache_build_stats`` hold
rii_tpu's keys, and a loaded layout is adopted only by a first cache build
that no mutation preceded."""

import functools

import numpy as np
import pytest

import rii_tpu
import rii_tpu.parallel as jpar
import rii_tpu.rii as jax_rii
from rii_tpu_torch import OPQ, PQ, Rii
from rii_tpu_torch.parallel import ShardedRii, make_mesh
from rii_tpu_torch.rii import estimate_best_threshold_function
from rii_tpu_torch.store import WindowStore
from rii_tpu_torch.utils.serialization import load_index, save_index

from _torch_parity import port_engine


def _engine(n=600, d=32):
    X = np.random.RandomState(5).random((n, d)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=16, device="cpu").fit(X, iter=3))
    e.add_configure(X, nlist=16)
    return e, X


def test_analytic_threshold_present_after_reconfigure():
    e, _ = _engine()
    assert isinstance(e.threshold, np.poly1d)
    assert e.threshold(1000) >= e.threshold(10)


def test_auto_routing_uses_threshold():
    e, X = _engine()
    assert e._use_linear(5, e.L0)
    ids, _ = e.query(X[0], topk=3, target_ids=np.arange(10, dtype=np.int64))
    assert set(ids) <= set(range(10))
    ids, _ = e.query(X[0], topk=3)
    assert ids[0] == 0


def test_auto_routing_prefers_ivf_when_candidate_work_is_small():
    X = np.random.RandomState(6).random((20000, 32)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=16, device="cpu").fit(X[:4000], iter=3))
    e.add_configure(X, nlist=100)
    e._ensure_cache()
    assert not e._use_linear(e.N, e.L0)  # IVF for a full search at small L
    # a mid-size subset widens the probe (wv grows as 1/|S|): linear
    assert e._use_linear(300, e.L0)


def test_timed_calibration_runs_and_fits():
    e, _ = _engine(n=300)
    probes = e.fine_quantizer.decode(e.codes[:20])
    p = estimate_best_threshold_function(e, probes)
    assert isinstance(p, np.poly1d)
    val = float(p(e.L0))
    assert -e.N <= val <= 2 * e.N


def test_timed_calibration_opq_rotates_probes(monkeypatch):
    X = np.random.RandomState(7).random((300, 32)).astype(np.float32)
    e = Rii(OPQ(M=4, Ks=16, device="cpu").fit(X, iter=3, rotation_iter=2))
    e.add_configure(X, nlist=8)
    rotated = []
    rotate = OPQ.rotate

    def counting_rotate(self, vecs):
        rotated.append(np.atleast_2d(vecs).shape[0])
        return rotate(self, vecs)

    monkeypatch.setattr(OPQ, "rotate", counting_rotate)
    probes = e.fine_quantizer.decode(e.codes[:10])
    p = estimate_best_threshold_function(e, probes)
    assert isinstance(p, np.poly1d)
    assert rotated and set(rotated) <= {1, 3, 10}


def test_reconfigure_calibrate_flag():
    e, _ = _engine(n=300)
    e.reconfigure(nlist=10, calibrate=True)
    assert isinstance(e.threshold, np.poly1d)
    assert e.nlist == 10


def test_auto_policy_batch_aware_union_cost_model():
    rng = np.random.RandomState(0)
    N, D = 8000, 32
    X = rng.random((N, D)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=32, device="cpu").fit(X[:1000], iter=3))
    e.scan_mode = "bf16"
    e.add_configure(X, nlist=90, iter=3)
    e._ensure_cache()
    L = e.L0
    assert not e._use_linear(N, L, qn=1)
    assert e._use_linear(N, L, qn=4096)


class _Took(Exception):
    """Raised where a query's route is decided: its argument names it."""


def _raise(route):
    def took(*args, **kw):
        raise _Took(route)
    return took


def _route(run, engine, linear_entry):
    """"linear" where ``run()`` reaches ``engine``'s linear entry, "ivf"
    where it reaches the window scan (both abort the query)."""
    setattr(engine, linear_entry, _raise("linear"))
    try:
        run()
    except _Took as took:
        return str(took)
    finally:
        delattr(engine, linear_entry)
    raise AssertionError("the query took neither route")


@functools.lru_cache(maxsize=None)
def _route_engines():
    """rii_tpu's engine and sharded engine (eight CPU shards), the port's
    over the same arrays: N=16000, nlist=400, each cache built."""
    X = np.random.RandomState(9).random((16000, 32)).astype(np.float32)
    je = rii_tpu.Rii(rii_tpu.PQ(M=4, Ks=32).fit(X[:1000], iter=3))
    je.add_configure(X, nlist=400, iter=3)
    te = port_engine(je)
    te.threshold = je.threshold
    for e in (je, te):
        e._ensure_cache()
    jsr = jpar.ShardedRii(je, use_decoded=False)
    tsr = ShardedRii(te, mesh=make_mesh(8, device="cpu"), use_decoded=False)
    return je, te, jsr, tsr, X


@pytest.mark.parametrize("qn", [1, 4, 16, 512])
@pytest.mark.parametrize("l0s", [0.25, 1, 8])
def test_routes_match_rii_tpu(monkeypatch, qn, l0s):
    """Over a grid of (Q, L, |S|), Rii and ShardedRii take rii_tpu's
    routes: the auto method's linear-or-IVF choice and, on the IVF path,
    the fallback of a union that covers half the index to the linear
    scan."""
    je, te, jsr, tsr, X = _route_engines()
    for name in ("ivf_union_scan_topk", "ivf_union_scan_topk_i8",
                 "ivf_union_scan_topk_pq"):
        monkeypatch.setattr(jax_rii, name, _raise("ivf"))
    monkeypatch.setattr(jsr, "_ivf_fn", lambda *a: _raise("ivf"))
    monkeypatch.setattr(WindowStore, "scan_topk", _raise("ivf"))
    q = np.ascontiguousarray(X[:qn])
    L = int(l0s * te.L0)
    for s in (None, 2000, 3900):
        tids = None if s is None else np.arange(0, 4 * s, 4, dtype=np.int64)
        n_s = te.N if s is None else s
        assert te._use_linear(n_s, L, qn=qn) == je._use_linear(n_s, L, qn=qn)
        assert (tsr._use_linear(q, 10, L, tids)
                == jsr._use_linear(q, 10, L, tids))
        routes = [_route(lambda e=e: e._query_ivf_batch(q, 10, tids, L), e,
                         "_query_linear_batch") for e in (te, je)]
        assert routes[0] == routes[1], (s, routes)
        routes = [_route(lambda e=e: e.query_ivf_batch(q, topk=10, L=L,
                                                        target_ids=tids),
                         e, "_query_linear_impl") for e in (tsr, jsr)]
        assert routes[0] == routes[1], (s, routes)


def test_stage_statistics_have_rii_tpu_keys():
    X = np.random.RandomState(8).random((2000, 32)).astype(np.float32)
    jpq = rii_tpu.PQ(M=4, Ks=16).fit(X[:500], iter=2)
    je = rii_tpu.Rii(jpq)
    te = Rii(PQ.from_codewords(jpq.codewords, device="cpu"))
    for e in (je, te):
        e.add(X, update_posting_lists=False)
        e.memory_breakdown()  # a cache built before any reconfigure
    assert set(te.last_cache_build_stats) == set(je.last_cache_build_stats)
    for e in (je, te):
        e.reconfigure(nlist=20, iter=2)
        e.query(X[0], topk=3)
    assert set(te.last_reconfigure_stats) == set(je.last_reconfigure_stats)
    assert set(te.last_cache_build_stats) == set(je.last_cache_build_stats)
    for k, v in te.last_reconfigure_stats.items():
        assert isinstance(v, float) and v >= 0, k
    for k, v in te.last_cache_build_stats.items():
        if k == "adopted_layout":
            assert v is False
        else:
            assert isinstance(v, float) and v >= 0, k


@pytest.mark.parametrize("mutation", ["reconfigure", "add", "clear"])
def test_adoption_invalidated_by_mutation(tmp_path, mutation):
    """A mutation between the load and the first query drops the loaded
    layout: the first cache build does not adopt it, and answers as an
    engine that never saw the checkpoint."""
    X = np.random.RandomState(9).random((3000, 32)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=16, device="cpu").fit(X[:800], iter=2))
    e.add_configure(X, nlist=24, iter=2)
    save_index(e, str(tmp_path / "idx"))
    r = load_index(str(tmp_path / "idx"), device="cpu")
    for eng in (e, r):
        if mutation == "reconfigure":
            eng.reconfigure(nlist=24, iter=3)
        elif mutation == "add":
            eng.add(X[:200])
        else:
            eng.clear()
            eng.add_configure(X[:2000], nlist=16, iter=2)
    assert r._layout_v is None or mutation == "add"
    ids_r, d_r = r.query_batch(X[:6], topk=5, method="ivf", L=300)
    assert r.last_cache_build_stats["adopted_layout"] is False
    assert r._layout_v is None and r._norms_cache is None
    ids_e, d_e = e.query_batch(X[:6], topk=5, method="ivf", L=300)
    np.testing.assert_array_equal(ids_r, ids_e)
    np.testing.assert_array_equal(d_r, d_e)
