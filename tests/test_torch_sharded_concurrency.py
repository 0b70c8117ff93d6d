"""Concurrency parity for growth, on the port's engine and its ShardedRii:
the counterparts of ``test_thread_safety.py``, ``test_mutation_races.py``,
``test_lifecycle_fuzz.py``, ``test_growth.py::test_sharded_failed_scatter_rebuilds``,
``test_input_contract.py::test_sharded_contracts``,
``test_serving.py::test_query_server_over_sharded_engine`` and
``test_deep1b_scale.py``'s sharded cases.

Queries race mutations: readers share the engine's lock, mutations (the
in-place scatters of an add, a reconfigure's swap, a refresh) hold it alone,
so a reader never sees a half-written cache or shard. Every thread join and
every wait has its own time limit, so that no case can hang the suite. The
shards are an eight-shard CPU mesh."""

import threading

import numpy as np
import pytest

import rii_tpu_torch.rii as rii_mod
import rii_tpu_torch.store as store_mod
from rii_tpu_torch import PQ, QueryServer, Rii
from rii_tpu_torch.parallel import ShardedRii, make_mesh

from _torch_parity import assert_ranked_ids_match

JOIN_S = 120  # the most any thread is waited for


def _mesh():
    return make_mesh(8, device="cpu")


def _join_all(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


@pytest.fixture(scope="module")
def base():
    rng = np.random.RandomState(7)
    N, D = 3000, 32
    X = rng.random((N + 2000, D)).astype(np.float32)
    pq = PQ(M=4, Ks=32, device="cpu").fit(X[:1000], iter=3)
    return pq, X, N


# --------------------------------------------------------------------------- #
# test_thread_safety.py
# --------------------------------------------------------------------------- #

def test_queries_race_incremental_adds(base):
    pq, X, N = base
    e = Rii(pq)
    e.add_configure(X[:N], nlist=50, iter=3)
    e.query_batch(X[:8], topk=5)  # the cache exists: adds scatter into it
    errors, stop = [], threading.Event()

    def reader():
        rng = np.random.RandomState(threading.get_ident() % 2**31)
        try:
            while not stop.is_set():
                q = np.ascontiguousarray(X[rng.randint(0, N, size=4)])
                ids, dists = e.query_batch(q, topk=5)
                assert ids.shape == (4, 5)
                assert (ids >= 0).all() and (ids < e.N).all()
                assert np.isfinite(dists).all()
                assert (np.diff(dists, axis=1) >= -1e-5).all()
        except Exception as exc:  # noqa: BLE001 - surfaced to the main thread
            errors.append(exc)

    readers = [threading.Thread(target=reader) for _ in range(4)]
    for t in readers:
        t.start()
    try:
        for i in range(8):
            lo = N + 250 * i
            e.add(X[lo:lo + 250])
    finally:
        stop.set()
        _join_all(readers)
    assert not errors, errors
    assert e.N == N + 2000
    assert e._stores is not None and e._stores[0].version == e._version  # scattered

    ref = Rii(pq)
    ref.add(X[:N], update_posting_lists=False)
    ref.reconfigure(nlist=50, iter=3)
    ref.add(X[N:N + 2000])
    q = np.ascontiguousarray(X[100:116])
    ids_a, dists_a = e.query_batch(q, topk=10)
    ids_b, dists_b = ref.query_batch(q, topk=10)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(dists_a, dists_b, rtol=1e-6)


def test_reconfigure_excludes_readers(base):
    pq, X, N = base
    e = Rii(pq)
    e.add_configure(X[:N], nlist=50, iter=3)
    e.query_batch(X[:8], topk=5)
    errors, done = [], threading.Event()

    def reader():
        try:
            while not done.is_set():
                ids, dists = e.query_batch(np.ascontiguousarray(X[:4]), topk=3)
                assert (ids >= 0).all() and np.isfinite(dists).all()
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        e.reconfigure(nlist=64, iter=2)
        e.clear()
        e.add(X[:N], update_posting_lists=False)
        e.reconfigure(nlist=50, iter=3)
    finally:
        done.set()
        _join_all(threads)
    # a reader may see the empty engine between clear and add ("No codes to
    # be searched", an AssertionError): the contract; never anything else
    for exc in errors:
        assert isinstance(exc, AssertionError), exc


def test_sharded_queries_race_delta_adds(base):
    """Queries against O(batch) delta adds (in-place scatters into the
    shards) stay valid, and end equal to a fresh wrapper over the same
    engine."""
    pq, X, N = base
    e = Rii(pq)
    e.add_configure(X[:N], nlist=50, iter=3)
    sr = ShardedRii(e, mesh=_mesh())
    sr.query_batch(np.ascontiguousarray(X[:8]), topk=5)
    codes0 = list(sr.codes)
    errors, stop = [], threading.Event()

    def reader():
        rng = np.random.RandomState(threading.get_ident() % 2**31)
        try:
            while not stop.is_set():
                q = np.ascontiguousarray(X[rng.randint(0, N, size=4)])
                ids, dists = sr.query_batch(q, topk=5)
                assert (ids >= 0).all() and (ids < e.N).all()
                assert np.isfinite(dists).all()
                ids, dists = sr.query_batch(q, topk=5, method="auto")
                assert (ids >= 0).all() and np.isfinite(dists).all()
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    readers = [threading.Thread(target=reader) for _ in range(3)]
    for t in readers:
        t.start()
    try:
        for i in range(6):
            lo = N + 250 * i
            sr.add(X[lo:lo + 250])
    finally:
        stop.set()
        _join_all(readers)
    assert not errors, errors
    assert sr._n_dev == N + 1500
    assert all(a is b for a, b in zip(sr.codes, codes0))  # no refresh

    ref = ShardedRii(e, mesh=_mesh())
    q = np.ascontiguousarray(X[50:66])
    ids_a, d_a = sr.query_batch(q, topk=10)
    ids_b, d_b = ref.query_batch(q, topk=10)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-6)


def test_sharded_stale_view_self_heals(base):
    """A direct engine mutation leaves the shards stale; the next wrapper add
    sees it and refreshes rather than scatter past the rows it missed."""
    pq, X, N = base
    e = Rii(pq)
    e.add_configure(X[:N], nlist=50, iter=3)
    sr = ShardedRii(e, mesh=_mesh())
    e.add(X[N:N + 300])
    sr.add(X[N + 300:N + 500])
    assert sr._n_dev == e.N == N + 500
    ids, _ = sr.query_batch(np.ascontiguousarray(X[N:N + 4]), topk=1)
    assert (ids[:, 0] >= N).all()


# --------------------------------------------------------------------------- #
# test_mutation_races.py
# --------------------------------------------------------------------------- #

def _engine(n=2048, d=32, nlist=32, seed=33):
    rng = np.random.RandomState(seed)
    X = rng.random((n, d)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=32, device="cpu").fit(X[:512], iter=3))
    e.add_configure(X, nlist=nlist, iter=3)
    return e, X


def test_external_reconfigure_then_sharded_add_self_heals():
    """An external reconfigure (same N, new assignments) between a sync
    and the next add: the version check forces a refresh, not a scatter
    into the stale windows."""
    e, X = _engine()
    X2 = np.random.RandomState(34).random((128, 32)).astype(np.float32)
    sr = ShardedRii(e, mesh=_mesh())
    e.reconfigure(nlist=48, iter=3)
    sr.add(X2, update_posting_lists=True)
    assert sr._engine_version == e._version

    e2, _ = _engine()
    e2.reconfigure(nlist=48, iter=3)
    e2.add(X2, update_posting_lists=True)
    sr2 = ShardedRii(e2, mesh=_mesh())
    for key in ("v_counts", "v_vstart"):
        np.testing.assert_array_equal(getattr(sr.windows[0], key),
                                      getattr(sr2.windows[0], key))
    q = X2[:8]
    for kw in ({}, {"method": "ivf", "L": e.N}):
        ids_a, d_a = sr.query_batch(q, topk=10, **kw)
        ids_b, d_b = sr2.query_batch(q, topk=10, **kw)
        assert_ranked_ids_match(ids_a, d_a, ids_b, d_b, rtol=1e-5)


def test_sharded_add_after_own_reconfigure_stays_delta():
    """Mutations through the wrapper keep its version in step: the add
    after its own reconfigure takes the O(batch) path."""
    e, X = _engine()
    sr = ShardedRii(e, mesh=_mesh())
    sr.reconfigure(nlist=48, iter=3)
    v0 = e._version
    codes0 = list(sr.codes)
    sr.add(np.random.RandomState(35).random((64, 32)).astype(np.float32),
           update_posting_lists=True)
    assert e._version == v0 + 1
    assert sr._engine_version == e._version
    assert all(a is b for a, b in zip(sr.codes, codes0))
    ids, _ = sr.query_batch(X[:4], topk=5, L=e.N)
    assert (ids >= 0).all()


def test_add_codes_rejects_out_of_range_codes():
    e, _ = _engine()
    bad = np.full((4, e.M), e.Ks, dtype=np.uint8)  # == Ks: out of range
    with pytest.raises(AssertionError, match="must be < Ks"):
        e.add_codes(bad)
    e.add_codes(np.zeros((4, e.M), dtype=np.uint8))
    assert e.N == 2052


def test_clear_racing_add_raises_guarded_error(monkeypatch):
    """clear() landing between _add_codes's unlocked predict and its write
    lock gives the guarded 'reconfigure() must be called' error."""
    e, X = _engine()
    codes = e.fine_quantizer.encode(X[:16])
    real_predict = rii_mod.pqkmeans_predict
    state = {"fired": False}

    def racing_predict(codewords, centers, cs, **kw):
        out = real_predict(codewords, centers, cs, **kw)
        if not state["fired"]:
            state["fired"] = True
            e.clear()
        return out

    monkeypatch.setattr(rii_mod, "pqkmeans_predict", racing_predict)
    with pytest.raises(RuntimeError, match="reconfigure\\(\\) must be called"):
        e._add_codes(codes, True)
    assert e.N == 0


# --------------------------------------------------------------------------- #
# test_lifecycle_fuzz.py (D=32, M=4, Ks=32)
# --------------------------------------------------------------------------- #

D, M, KS = 32, 4, 32


@pytest.fixture(scope="module")
def codec():
    X = np.random.RandomState(0).random((2000, D)).astype(np.float32)
    return PQ(M=M, Ks=KS, device="cpu").fit(X, iter=3)


def _fresh(pq, data, nlist):
    e = Rii(pq)
    e.add(np.concatenate(data), update_posting_lists=False)
    e.reconfigure(nlist=nlist, iter=3)
    return e


def test_random_lifecycle_matches_fresh_build(codec):
    pq = codec
    rng = np.random.RandomState(7)
    e = Rii(pq)
    nlist = 30
    data = [rng.random((1500, D)).astype(np.float32)]
    e.add_configure(data[0], nlist=nlist, iter=3)
    for _ in range(6):
        op = rng.randint(0, 3)
        if op == 0:
            b = rng.random((rng.randint(50, 400), D)).astype(np.float32)
            data.append(b)
            e.add(b, update_posting_lists=True)
        elif op == 1:
            b = rng.random((rng.randint(50, 300), D)).astype(np.float32)
            other = Rii(pq)
            other.add(b, update_posting_lists=False)
            data.append(b)
            e.merge(other, update_posting_lists=True)
        else:
            nlist = int(rng.choice([20, 30, 45]))
            e.reconfigure(nlist=nlist, iter=3)
        assert e.N == sum(len(b) for b in data)
        assert sum(len(p) for p in e.posting_lists) == e.N
        np.testing.assert_array_equal(e.codes, pq.encode(np.concatenate(data)))
        q = np.concatenate(data)[0]
        ids_a, d_a = e.query(q, topk=5, L=e.N, method="ivf")
        f = _fresh(pq, data, nlist=min(nlist, e.N))
        ids_b, d_b = f.query(q, topk=5, L=f.N, method="ivf")
        np.testing.assert_allclose(np.sort(d_a), np.sort(d_b), rtol=1e-4)
    e.clear()
    assert e.N == 0 and e.nlist == 0 and e.threshold is None
    e.add_configure(np.concatenate(data), nlist=25, iter=3)
    assert e.N == sum(len(b) for b in data)


def test_add_without_update_then_reconfigure_includes_all(codec):
    pq = codec
    rng = np.random.RandomState(3)
    e = Rii(pq)
    a = rng.random((800, D)).astype(np.float32)
    b = rng.random((400, D)).astype(np.float32)
    e.add_configure(a, nlist=25, iter=3)
    e.add(b, update_posting_lists=False)
    assert e.N == 1200
    assert sum(len(p) for p in e.posting_lists) == 800
    e.reconfigure(nlist=25, iter=3)
    assert sum(len(p) for p in e.posting_lists) == 1200
    ids, _ = e.query(b[7], topk=5, L=e.N, method="ivf")
    assert 800 + 7 in ids.tolist()


def test_sharded_random_lifecycle_matches_engine(codec):
    """add / merge / distributed reconfigure through ShardedRii track a
    single-device engine fed the same operations; each reconfigure is
    bit-identical on the eight-shard mesh."""
    pq = codec
    rng = np.random.RandomState(17)
    nlist = 24
    b0 = rng.random((1200, D)).astype(np.float32)
    e = Rii(pq)
    e.add_configure(b0, nlist=nlist, iter=3)
    s = ShardedRii(e, mesh=_mesh())
    shadow = Rii(pq)
    shadow.add_configure(b0, nlist=nlist, iter=3)
    for _ in range(5):
        op = rng.randint(0, 3)
        if op == 0:
            b = rng.random((rng.randint(100, 400), D)).astype(np.float32)
            s.add(b, update_posting_lists=True)
            shadow.add(b, update_posting_lists=True)
        elif op == 1:
            b = rng.random((rng.randint(50, 200), D)).astype(np.float32)
            other = Rii(pq)
            other.add(b, update_posting_lists=False)
            s.merge(other)
            shadow.merge(other)
        else:
            s.reconfigure(nlist=nlist, iter=3)
            shadow.reconfigure(nlist=nlist, iter=3)
            np.testing.assert_array_equal(e.coarse_centers, shadow.coarse_centers)
            assert s.engine.posting_lists == shadow.posting_lists
        assert s.engine.N == shadow.N == s._n_dev
        q = rng.random((4, D)).astype(np.float32)
        ids_s, d_s = s.query_batch(q, topk=3)
        ids_e, d_e = shadow.query_batch(q, topk=3, method="linear")
        assert_ranked_ids_match(ids_s, d_s, ids_e, d_e, rtol=1e-5)


# --------------------------------------------------------------------------- #
# growth, input contract, serving
# --------------------------------------------------------------------------- #

def test_sharded_failed_scatter_rebuilds(monkeypatch):
    """A scatter that fails part way (an injected out-of-memory error) is
    not raised: the shards are rebuilt under the same lock, with the batch."""
    rng = np.random.RandomState(38)
    X1 = rng.random((2048, 32)).astype(np.float32)
    X2 = rng.random((128, 32)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=32, device="cpu").fit(X1[:512], iter=3))
    e.add_configure(X1, nlist=32, iter=3)
    sr = ShardedRii(e, mesh=_mesh())
    codes0 = list(sr.codes)
    real = store_mod._set_rows
    calls = [0]

    def flaky(t, idx, rows):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("CUDA out of memory (injected)")
        return real(t, idx, rows)

    monkeypatch.setattr(store_mod, "_set_rows", flaky)
    sr.add(X2)
    monkeypatch.setattr(store_mod, "_set_rows", real)
    assert calls[0] >= 2
    assert sr._n_dev == e.N == 2176
    assert sr._engine_version == e._version
    assert not any(a is b for a, b in zip(sr.codes, codes0))  # rebuilt
    ids, _ = sr.query_batch(np.ascontiguousarray(X2[:4]), topk=1)
    assert (ids[:, 0] >= 2048).all()
    ref = ShardedRii(e, mesh=_mesh())
    q = np.ascontiguousarray(X1[10:18])
    ids_a, d_a = sr.query_batch(q, topk=5)
    ids_b, d_b = ref.query_batch(q, topk=5)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(d_a, d_b)


def test_sharded_contracts():
    rng = np.random.RandomState(7)
    X = rng.random((1500, 32)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=32, device="cpu").fit(X[:500], iter=3))
    e.add_configure(X, nlist=24, iter=3)
    sr = ShardedRii(e, mesh=_mesh())
    for method in ("linear", "ivf"):
        with pytest.raises(TypeError, match="float32"):
            sr.query_batch(X[:4].astype(np.float64), topk=3, method=method)
        with pytest.raises(TypeError, match="int64"):
            sr.query_batch(X[:4], topk=3, method=method,
                           target_ids=np.arange(100, dtype=np.int32))
    with pytest.raises(AssertionError):
        sr.add(X[:4].astype(np.float64))
    assert sr._n_dev == e.N == 1500


def test_query_server_over_sharded_engine():
    """The QueryServer takes a ShardedRii: concurrent clients get what
    query_batch gives (method "linear": "auto" routes by batch size, so
    its answer would depend on thread timing)."""
    rng = np.random.RandomState(0)
    X = rng.random((4000, 32)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=32, device="cpu").fit(X[:1000], iter=3))
    e.add_configure(X, nlist=60, iter=3)
    sr = ShardedRii(e, mesh=_mesh())
    with QueryServer(sr, max_wait_ms=5, dispatchers=2) as srv:
        fut = srv.submit(X[7], topk=5, method="linear")
        ids, dists = fut.result(timeout=JOIN_S)
        futs = [srv.submit(X[i], topk=5, method="linear") for i in range(16)]
        res = [f.result(timeout=JOIN_S) for f in futs]
    assert ids.shape == (5,)
    ids_d, dists_d = sr.query_batch(X[7:8], topk=5)
    assert_ranked_ids_match(ids[None], dists[None], ids_d, dists_d, rtol=1e-5)
    ids_b, d_b = sr.query_batch(X[:16], topk=5)
    assert_ranked_ids_match(np.stack([r[0] for r in res]),
                            np.stack([r[1] for r in res]), ids_b, d_b, rtol=1e-5)


# --------------------------------------------------------------------------- #
# test_deep1b_scale.py's sharded cases, at a small size (Deep1B's Ds=8)
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def deep_engine():
    X = np.random.RandomState(0).random((8192, 32)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=256, device="cpu").fit(X[:4096], iter=3))
    e.scan_mode = "bf16"
    e.add_configure(X, nlist=128, iter=3)
    return e, X


def test_deep1b_config_sharded_linear_and_ivf(deep_engine):
    e, X = deep_engine
    sr = ShardedRii(e, mesh=_mesh(), use_decoded=True)
    assert sr.windows is not None and sr.tier == "bf16"
    qs = X[:8]
    ids_l, d_l = sr.query_batch(qs, topk=10)
    assert (ids_l[:, 0] == np.arange(8)).all()  # self-hit at rank 1
    ids_i, d_i = sr.query_ivf_batch(qs, topk=10, L=e.N)
    for a, b in zip(ids_l, ids_i):
        assert set(a.tolist()) == set(b.tolist())


def test_deep1b_config_single_device_matches_sharded(deep_engine):
    e, X = deep_engine
    sr = ShardedRii(e, mesh=_mesh(), use_decoded=True)
    qs = X[100:108]
    ids_s, d_s = sr.query_batch(qs, topk=5)
    ids_1, d_1 = e.query_batch(qs, topk=5, method="linear")
    assert_ranked_ids_match(ids_s, d_s, ids_1, d_1, rtol=1e-5)
