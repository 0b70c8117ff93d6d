"""The port's QueryServer (rii_tpu_torch.serving): the cases of
tests/test_serving.py but its sharded one, on a CPU engine.

Answers are held against the engine's own ``query_batch`` with
``assert_ranked_ids_match`` (distances within 1e-5 relative), never by
exact ids across batches of another composition: the batch a request
lands in depends on thread timing, and its size may change the float32
rounding of the scores. Requests that the comparison needs go through
``method="linear"``, since ``auto`` picks the route by the batch's size.
Every server is stopped in a ``with`` block or a ``finally``, and every
wait has a timeout."""

import os
import queue as queue_mod
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import rii_tpu
import rii_tpu.serving
from rii_tpu_torch import PQ, QueryServer, Rii
from rii_tpu_torch.serving import _Request
from rii_tpu_torch.utils.convert import engine_from_arrays

from _torch_parity import assert_ranked_ids_match

RTOL = 1e-5


@pytest.fixture(scope="module")
def engine():
    rng = np.random.RandomState(0)
    N, D = 4000, 32
    X = rng.random((N, D)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=32, device="cpu").fit(X[:1000], iter=3))
    e.add_configure(X, nlist=60, iter=3)
    return e, X


def test_single_request_matches_direct_and_squeezes(engine):
    e, X = engine
    with QueryServer(e) as srv:
        ids, dists = srv.submit(X[3], topk=5).result(timeout=60)
    assert ids.shape == (5,) and dists.shape == (5,)
    ids_d, dists_d = e.query_batch(X[3:4], topk=5)
    np.testing.assert_array_equal(ids, ids_d[0])
    np.testing.assert_allclose(dists, dists_d[0], rtol=1e-6)


def test_minibatch_request_stays_2d(engine):
    e, X = engine
    with QueryServer(e) as srv:
        ids, dists = srv.submit(X[3:6], topk=5).result(timeout=60)
    assert ids.shape == (3, 5) and dists.shape == (3, 5)
    ids_d, d_d = e.query_batch(np.ascontiguousarray(X[3:6]), topk=5)
    np.testing.assert_array_equal(ids, ids_d)
    np.testing.assert_allclose(dists, d_d, rtol=1e-6)


def test_concurrent_submissions_batch_and_match(engine):
    e, X = engine
    picks = np.random.RandomState(1).choice(e.N, 32, replace=False)
    direct_ids, direct_d = e.query_batch(np.ascontiguousarray(X[picks]),
                                         topk=5, method="linear")
    futs = {}
    with QueryServer(e, max_batch=64, max_wait_ms=20) as srv:
        def submit(i):
            futs[i] = srv.submit(X[picks[i]], topk=5, method="linear")

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        results = {i: f.result(timeout=60) for i, f in futs.items()}
    ids = np.stack([results[i][0] for i in range(32)])
    dists = np.stack([results[i][1] for i in range(32)])
    assert_ranked_ids_match(ids, dists, direct_ids, direct_d, RTOL)
    stats = srv.stats()
    assert stats["served"] == 32
    assert stats["p50_s"] is not None and stats["qps"] > 0


def test_mixed_topk_groups(engine):
    e, X = engine
    with QueryServer(e, max_wait_ms=5) as srv:
        f1 = srv.submit(X[1], topk=3)
        f2 = srv.submit(X[2], topk=7)  # another topk: another dispatch
        i1, d1 = f1.result(timeout=60)
        i2, d2 = f2.result(timeout=60)
    assert i1.shape == (3,) and i2.shape == (7,)
    r1, rd1 = e.query_batch(X[1:2], topk=3)
    r2, rd2 = e.query_batch(X[2:3], topk=7)
    assert_ranked_ids_match(i1[None], d1[None], r1, rd1, RTOL)
    assert_ranked_ids_match(i2[None], d2[None], r2, rd2, RTOL)


def test_incompatible_request_preserves_fifo(engine):
    """An incompatible request leads the next group; it is not queued again
    at the back, where a steady compatible stream would starve it."""
    e, X = engine
    srv = QueryServer(e, max_wait_ms=50)
    f_a = srv.submit(X[1], topk=3)
    f_odd = srv.submit(X[2], topk=7)
    f_b = srv.submit(X[3], topk=3)
    followers = [srv.submit(X[4 + i], topk=3) for i in range(8)]
    srv.start()
    try:
        i_odd, _ = f_odd.result(timeout=60)
        assert i_odd.shape == (7,)
        for f in [f_a, f_b] + followers:
            f.result(timeout=60)
    finally:
        srv.stop()


def test_target_ids_request(engine):
    e, X = engine
    tids = np.arange(0, 2000, dtype=np.int64)
    with QueryServer(e) as srv:
        ids, _ = srv.submit(X[5], topk=5, target_ids=tids).result(timeout=60)
    assert set(ids.tolist()) <= set(tids.tolist())


def test_error_propagates(engine):
    e, X = engine
    with QueryServer(e) as srv:
        fut = srv.submit(X[0], topk=e.N + 1)  # topk past N: AssertionError
        with pytest.raises(AssertionError):
            fut.result(timeout=60)


def test_wrong_dtype_rejected_at_submit(engine):
    e, X = engine
    with QueryServer(e) as srv:
        with pytest.raises(TypeError):
            srv.submit(X[0].astype(np.float64), topk=3)
        with pytest.raises(TypeError):
            srv.submit(X[0], topk=3, target_ids=np.arange(10, dtype=np.int32))


def test_stop_drains_pending_and_rejects_new(engine):
    e, X = engine
    srv = QueryServer(e)
    fut = srv.submit(X[0], topk=3)  # never started
    srv.stop()
    with pytest.raises(RuntimeError, match="server stopped"):
        fut.result(timeout=5)
    with pytest.raises(RuntimeError, match="server stopped"):
        srv.submit(X[1], topk=3)


def test_backpressure_bounded_queue(engine):
    e, X = engine
    srv = QueryServer(e, max_queue=2, submit_timeout_s=0.05)
    try:
        srv.submit(X[0], topk=3)
        srv.submit(X[1], topk=3)
        with pytest.raises(queue_mod.Full):
            srv.submit(X[2], topk=3)  # queue full, no dispatcher running
    finally:
        srv.stop()


def test_same_mask_subset_requests_batch_and_resolve(engine):
    e, X = engine
    tids_a = np.sort(np.random.RandomState(1).choice(
        e.N, 200, replace=False)).astype(np.int64)
    tids_b = np.sort(np.random.RandomState(2).choice(
        e.N, 150, replace=False)).astype(np.int64)
    with QueryServer(e, max_wait_ms=20, dispatchers=2) as srv:
        futs_a = [srv.submit(X[i], topk=3, target_ids=tids_a.copy())
                  for i in range(6)]
        futs_b = [srv.submit(X[i], topk=3, target_ids=tids_b) for i in range(3)]
        futs_f = [srv.submit(X[i], topk=3) for i in range(4)]
        for i, f in enumerate(futs_a + futs_b):
            ids, _ = f.result(timeout=120)
            tset = tids_a if i < 6 else tids_b
            assert set(ids.tolist()) <= set(tset.tolist())
        for f in futs_f:
            ids, _ = f.result(timeout=120)
            assert ids.shape == (3,)
    r1 = _Request(X[:1], 3, None, tids_a.copy(), "auto", True)
    r2 = _Request(X[:1], 3, None, tids_a.copy(), "auto", True)
    r3 = _Request(X[:1], 3, None, tids_b, "auto", True)
    assert r1.tid_key == r2.tid_key != r3.tid_key


def test_dispatcher_pool_subset_does_not_stall_stream(engine):
    e, X = engine
    rng = np.random.RandomState(5)
    with QueryServer(e, max_wait_ms=1, dispatchers=2) as srv:
        futs = []
        for i in range(12):
            if i % 2 == 0:
                tids = np.sort(rng.choice(e.N, 100 + i, replace=False)
                               ).astype(np.int64)
                futs.append(srv.submit(X[i], topk=2, target_ids=tids))
            else:
                futs.append(srv.submit(X[i], topk=2))
        for f in futs:
            _, dists = f.result(timeout=120)
            assert np.isfinite(dists).all()
    assert srv.stats()["served"] == 12


def test_stress_more_clients_than_cores(engine):
    """More client threads than cores, switching every few microseconds:
    every request is answered as query_batch answers it, and the served
    count (summed by the dispatchers under a lock) loses nothing."""
    e, X = engine
    clients, per = 2 * (os.cpu_count() or 4), 6
    rows = [(c * 37 + i * 11) % e.N for c in range(clients) for i in range(per)]
    direct_ids, direct_d = e.query_batch(np.ascontiguousarray(X[rows]), topk=3,
                                         method="linear")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with QueryServer(e, max_batch=16, max_wait_ms=1, dispatchers=3) as srv:
            def client(c):
                return [srv.submit(X[rows[c * per + i]], topk=3, method="linear")
                        for i in range(per)]

            with ThreadPoolExecutor(clients) as pool:
                futs = [f for fs in pool.map(client, range(clients)) for f in fs]
            results = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(old)
    # a dispatcher counts a request after resolving its future: read the
    # count once stop() has joined the dispatchers
    assert srv.stats()["served"] == clients * per
    ids = np.stack([r[0] for r in results])
    dists = np.stack([r[1] for r in results])
    assert_ranked_ids_match(ids, dists, direct_ids, direct_d, RTOL)


def test_served_answers_match_rii_tpu_server():
    """The same requests through rii_tpu's QueryServer over a rii_tpu
    engine and through the port's over the port's engine on its arrays
    (exact mode): ids per rank but at ties, distances within 3e-6."""
    X = np.random.RandomState(4).random((3000, 32)).astype(np.float32)
    # M=8: no two rows share a code (the packages order exact ties
    # differently at the top-k boundary)
    je = rii_tpu.Rii(rii_tpu.PQ(M=8, Ks=16).fit(X[:800], iter=2))
    je.topk_recall = None
    je.add_configure(X, nlist=40, iter=2)
    te = engine_from_arrays(je.codewords, je.codes, je.coarse_centers,
                            je._assignments(), device="cpu")
    te.topk_recall = None
    tids = np.arange(0, 3000, 3, dtype=np.int64)
    answers = []
    for server, eng in ((rii_tpu.serving.QueryServer, je), (QueryServer, te)):
        with server(eng, max_wait_ms=5) as srv:
            futs = [srv.submit(X[i], topk=5, method="linear") for i in range(8)]
            futs += [srv.submit(X[8:12], topk=5, method="ivf", L=300)]
            futs += [srv.submit(X[i], topk=5, target_ids=tids) for i in range(4)]
            answers.append([f.result(timeout=120) for f in futs])
    for (ij, dj), (it, dt) in zip(*answers):
        assert_ranked_ids_match(np.atleast_2d(it), np.atleast_2d(dt),
                                np.atleast_2d(ij), np.atleast_2d(dj), 3e-6)
    for ids, _ in answers[1][-4:]:
        assert set(ids.tolist()) <= set(tids.tolist())


class _SlowEngine:
    """query_batch sleeps: a device slower than the submit stream."""

    def __init__(self, delay_s):
        self.delay_s = delay_s

    def query_batch(self, batch, topk=1, L=None, target_ids=None,
                    method="auto"):
        time.sleep(self.delay_s)
        n = batch.shape[0]
        return (np.zeros((n, topk), np.int64), np.zeros((n, topk), np.float32))


def test_backpressure_holds_under_slow_dispatch():
    """A running server over a slow engine still holds max_queue: the
    bounded staging queue keeps the group former from draining submissions
    faster than the dispatchers retire them."""
    srv = QueryServer(_SlowEngine(0.3), max_batch=1, max_queue=2,
                      max_wait_ms=0.0, submit_timeout_s=0.05, dispatchers=1)
    srv.start()
    q = np.zeros(8, np.float32)
    try:
        with pytest.raises(queue_mod.Full):
            for _ in range(32):
                srv.submit(q, topk=1)
    finally:
        srv.stop()


def test_concurrent_cold_cache_builds_once():
    """The dispatchers call query_batch concurrently; a cold cache is built
    once (racing builds would hold it twice in device memory)."""
    X = np.random.RandomState(3).random((3000, 32)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=32, device="cpu").fit(X[:1000], iter=2))
    e.add_configure(X, nlist=40, iter=2)
    assert e._stores is None  # nothing has queried it yet
    calls = []
    orig = Rii._build_cache

    def counted(self):
        calls.append(threading.get_ident())
        time.sleep(0.05)  # widen the race window
        return orig(self)

    e._build_cache = types.MethodType(counted, e)
    with QueryServer(e, max_batch=4, max_wait_ms=0.0, dispatchers=4) as srv:
        futs = [srv.submit(X[:4], topk=3, method="linear") for _ in range(4)]
        results = [f.result(timeout=120) for f in futs]
    assert len(calls) == 1, calls
    ids_d, d_d = e.query_batch(X[:4], topk=3, method="linear")
    assert len(calls) == 1, calls
    for ids, dists in results:
        assert_ranked_ids_match(ids, dists, ids_d, d_d, RTOL)
