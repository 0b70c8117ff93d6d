"""O(batch) growth and the other mutations of rii_tpu_torch.Rii, the cases
of tests/test_growth.py at the bf16, pq and int8 tiers.

Each tier runs on its kernel route (``force_kernel_routing``: the
transposed bf16 replica of kernel A, the transposed codes of kernel C, the
int8 replica of kernel F with the int8 windows of kernel G), so the
scatters write the caches the card uses. Where the JAX engine is the
comparison it runs the same tier through Pallas interpret mode, and results
agree in the bf16 class (3e-2) with equal nearest neighbours.

The cases that query IVF in exact mode (a one-query union stays off the
linear scan only unpadded) build the int8 cache on the kernel route first
and then turn exact mode on: the int8 tier exists only there, and the cache
keeps its windows (as in the JAX engine)."""

import numpy as np
import pytest
import torch

import rii_tpu
from rii_tpu_torch import PQ, Rii
from rii_tpu_torch import store as store_mod
from rii_tpu_torch.ops.decode import onehot_decode
from rii_tpu_torch.ops.hopper_i8 import quantize_rows_i8
from rii_tpu_torch.parallel import ShardedRii, make_mesh

D = 32
FAST_RTOL = 3e-2
TIERS = {"bf16": "decoded_t", "pq": "codes_t", "int8": "decoded_i8"}


@pytest.fixture(scope="module")
def cw():
    X = np.random.RandomState(20).random((2000, D)).astype(np.float32)
    return rii_tpu.PQ(M=4, Ks=32).fit(X, iter=5).codewords


def _data(seed, *sizes):
    rng = np.random.RandomState(seed)
    return [rng.random((n, D)).astype(np.float32) for n in sizes]


def _engine(cw, tier, exact=False):
    e = Rii(PQ.from_codewords(cw, device="cpu"))
    e.scan_mode = tier
    e.force_kernel_routing = True
    if exact:
        e.topk_recall = None
    return e


def _jax_engine(cw, tier):
    je = rii_tpu.Rii(rii_tpu.PQ.from_codewords(cw))
    je.scan_mode = tier
    je.pallas_interpret = True
    return je


def _assert_close_to(ids_a, d_a, ids_b, d_b):
    np.testing.assert_allclose(d_a, d_b, rtol=FAST_RTOL, atol=FAST_RTOL)
    assert (ids_a[:, 0] == ids_b[:, 0]).all()


@pytest.mark.parametrize("tier", list(TIERS))
def test_incremental_add_keeps_cache_and_matches_rebuild(cw, tier):
    """add() after a build scatters into the live cache, answers as a
    rebuilt cache does, and as the JAX engine after the same add."""
    X1, X2 = _data(21, 3000, 200)
    e = _engine(cw, tier)
    e.add_configure(X1, nlist=40)
    st = e._ensure_cache()
    lin, win = st
    assert lin.form == TIERS[tier]
    e.add(X2)  # auto -> update_posting_lists=True
    assert e._stores is st and lin.version == e._version
    assert lin.n_dev == 3200

    r = _engine(cw, tier)
    r.add_configure(X1, nlist=40)
    r.add(X2)
    assert r._stores is None  # no cache yet: the first query builds it whole
    qs = np.ascontiguousarray(np.concatenate([X1[:4], X2[:4]]))
    ids_e, d_e = e.query_batch(qs, topk=10, method="linear")
    ids_r, d_r = r.query_batch(qs, topk=10, method="linear")
    np.testing.assert_array_equal(ids_e, ids_r)
    np.testing.assert_array_equal(d_e, d_r)
    rc = r._ensure_cache()[0].tensors()
    for key, t in lin.tensors().items():
        if key != "codewords":
            assert torch.equal(t, rc[key]), key
    # the windows hold every id once (the rebuild lays them out anew)
    og = win.order_g
    assert sorted(og[og >= 0].tolist()) == list(range(3200))
    if win.tier == "int8":  # each id's window row: its quantized decode
        live = og[og >= 0].long()
        dec = onehot_decode(lin.codes_flat[live], lin.codewords, torch.bfloat16)
        assert torch.equal(win.rows[og >= 0],
                           quantize_rows_i8(dec, win.i8_scales_g))
    assert sum(len(p) for p in e.posting_lists) == 3200

    je = _jax_engine(cw, tier)
    je.add_configure(X1, nlist=40)
    je._ensure_cache()
    je.add(X2)
    assert je._dc is not None
    assert e.posting_lists == je.posting_lists
    _assert_close_to(ids_e, d_e, *je.query_batch(qs, topk=10, method="linear"))


@pytest.mark.parametrize("tier", list(TIERS))
def test_sharded_incremental_add_matches_rebuild(cw, tier):
    """ShardedRii's add() scatters into its live shards (the linear chunks'
    and each shard's window store's tensors, in place) and then holds what
    a fresh refresh() of the same engine holds, and answers as it does."""
    X1, X2 = _data(21, 3000, 200)
    use_decoded = {"bf16": True, "int8": "i8", "pq": False}[tier]
    e = _engine(cw, tier)
    e.add_configure(X1, nlist=40)
    sr = ShardedRii(e, mesh=make_mesh(4, device="cpu"), use_decoded=use_decoded)
    assert sr.tier == tier and all(w.tier == tier for w in sr.windows)
    stores = [*sr.windows, *(lin for ls in sr.linear for lin in ls)]
    sr.add(X2)  # auto -> update_posting_lists=True
    assert sr._n_dev == 3200 and sr._engine_version == e._version
    now = [*sr.windows, *(lin for ls in sr.linear for lin in ls)]
    assert all(a is b for a, b in zip(now, stores))  # no refresh

    ref = ShardedRii(e, mesh=make_mesh(4, device="cpu"), use_decoded=use_decoded)
    for a, b in zip(sr.windows + [x for ls in sr.linear for x in ls],
                    ref.windows + [x for ls in ref.linear for x in ls]):
        ta, tb = a.tensors(), b.tensors()
        assert ta.keys() == tb.keys()
        for key in ta:
            assert torch.equal(ta[key], tb[key]), key
    for key in ("v_counts", "v_vstart", "v_capacity"):
        np.testing.assert_array_equal(getattr(sr.windows[0], key),
                                      getattr(ref.windows[0], key))
    qs = np.ascontiguousarray(np.concatenate([X1[:4], X2[:4]]))
    for method in ("linear", "ivf"):
        ids_a, d_a = sr.query_batch(qs, topk=10, L=400, method=method)
        ids_b, d_b = ref.query_batch(qs, topk=10, L=400, method=method)
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_array_equal(d_a, d_b)


@pytest.mark.parametrize("tier", list(TIERS))
def test_incremental_add_finds_new_ids_through_ivf(cw, tier):
    """The new rows join their posting lists: an IVF batch that stays off
    the linear scan finds them (exact mode: Q is not padded, so a one-query
    union of 4 windows is under half the capacity)."""
    X1, X2 = _data(22, 3000, 200)
    e = _engine(cw, tier, exact=tier != "int8")
    e.add_configure(X1, nlist=40)
    win = e._ensure_cache()[1]
    if tier == "int8":  # the add scatters into the int8 windows
        assert win.tier == "int8"
    e.topk_recall = None
    e.add(X2)
    assert e._stores is not None
    dec = e.fine_quantizer.decode(e.codes[3000:3008])  # at distance 0
    hits = [3000 + i in e.query(dec[i], topk=5, L=100, method="ivf")[0]
            for i in range(8)]
    assert all(hits)


@pytest.mark.parametrize("tier", list(TIERS))
def test_incremental_add_overflow_falls_back_to_rebuild(cw, tier):
    X1, X2 = _data(23, 2000, 3000)  # more than the pow2 cap and the headroom
    e = _engine(cw, tier)
    e.add_configure(X1, nlist=30)
    e._ensure_cache()
    e.add(X2)
    assert e._stores is None
    ids, _ = e.query(X2[11], topk=3, method="linear")
    assert 2011 in ids
    assert e._ensure_cache()[0].n_dev == 5000


@pytest.mark.parametrize("tier", list(TIERS))
def test_add_without_update_is_invisible_to_ivf_until_reconfigure(cw, tier):
    X1, X2 = _data(24, 3000, 100)
    e = _engine(cw, tier, exact=tier != "int8")
    e.add_configure(X1, nlist=40)
    e._ensure_cache()
    e.topk_recall = None
    e.add(X2, update_posting_lists=False)
    assert e._stores is not None  # a linear-only scatter keeps the cache
    assert 3005 in e.query(X2[5], topk=3, method="linear")[0]
    assert sum(len(p) for p in e.posting_lists) == 3000
    assert 3005 not in e.query(X2[5], topk=3, L=100, method="ivf")[0]
    e.reconfigure(nlist=40)
    assert sum(len(p) for p in e.posting_lists) == 3100
    assert 3005 in e.query(X2[5], topk=3, L=3100, method="ivf")[0]


@pytest.mark.parametrize("tier", list(TIERS))
def test_empty_add_keeps_cache(cw, tier):
    (X,) = _data(31, 2000)
    e = _engine(cw, tier)
    e.add_configure(X, nlist=30)
    e.query_batch(X[:2], topk=3)
    st = e._stores
    e.add(np.zeros((0, D), np.float32))
    assert e._stores is st and st[0].version == e._version
    ids, _ = e.query_batch(X[:2], topk=3)
    assert e._stores is st
    assert ids[0, 0] == 0 and ids[1, 0] == 1


@pytest.mark.parametrize("tier", list(TIERS))
def test_reserve_keeps_cache_beyond_pow2(cw, tier):
    X1, X2 = _data(29, 2048, 600)  # N a power of two: the first add overflows
    e0 = _engine(cw, tier)
    e0.add_configure(X1, nlist=32)
    e0._ensure_cache()
    e0.add(X2)
    assert e0._stores is None

    e = _engine(cw, tier).reserve(2048 + 1024)
    e.add_configure(X1, nlist=32)
    assert e._ensure_cache()[0].cap >= 2048 + 1024
    e.add(X2)
    assert e._stores is not None and e._stores[0].n_dev == 2648
    q = np.ascontiguousarray(X2[:8])
    ids_a, d_a = e.query_batch(q, topk=5, method="linear")
    ids_b, d_b = e0.query_batch(q, topk=5, method="linear")
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-6)


@pytest.mark.parametrize("tier", list(TIERS))
def test_reserve_scales_window_headroom(cw, tier):
    X1, X2 = _data(31, 2000, 900)  # +45%, past the default 12.5% headroom
    e = _engine(cw, tier).reserve(3000)
    e.add_configure(X1, nlist=32)
    e._ensure_cache()
    e.add(X2, update_posting_lists=True)
    assert e._stores is not None
    win = e._stores[1]
    assert int(win.v_counts.sum()) == 2900
    if tier != "bf16":  # the pq and int8 windows' member counts follow
        vl = win.vlen_g.numpy()
        assert vl.sum() == 2900 and (vl <= win.cap_v).all()


@pytest.mark.parametrize("tier", list(TIERS))
def test_failed_scatter_drops_cache(cw, tier, monkeypatch):
    """A scatter failing part way drops both stores (never half-written)
    and the add itself stands."""
    X1, X2 = _data(37, 3000, 100)
    e = _engine(cw, tier)
    e.add_configure(X1, nlist=40)
    e._ensure_cache()
    real_set = store_mod._set_rows
    calls = [0]

    def flaky(t, idx, rows):
        calls[0] += 1
        if calls[0] == 2:  # fail after the first scatter landed
            raise RuntimeError("out of memory (injected)")
        return real_set(t, idx, rows)

    # every row write of the add goes through store._set_rows
    monkeypatch.setattr(store_mod, "_set_rows", flaky)
    e.add(X2)
    monkeypatch.setattr(store_mod, "_set_rows", real_set)
    assert calls[0] == 2
    assert e._stores is None and e.N == 3100
    assert 3005 in e.query(X2[5], topk=3, method="linear")[0]


@pytest.mark.parametrize("tier", list(TIERS))
def test_clear_then_rebuild(cw, tier):
    X1, X2 = _data(41, 2000, 1500)
    e = _engine(cw, tier)
    e.add_configure(X1, nlist=20)
    e.query_batch(X1[:2], topk=3)
    e.clear()
    assert e.N == 0 and e.nlist == 0 and e.threshold is None and e._stores is None
    assert e.codewords is not None
    with pytest.raises(RuntimeError):
        e.add(X2, update_posting_lists=True)
    e.add_configure(X2, nlist=20)
    f = _engine(cw, tier).add_configure(X2, nlist=20)
    assert e.posting_lists == f.posting_lists
    q = np.ascontiguousarray(X2[:8])
    ids_e, d_e = e.query_batch(q, topk=5)
    ids_f, d_f = f.query_batch(q, topk=5)
    np.testing.assert_array_equal(ids_e, ids_f)
    np.testing.assert_array_equal(d_e, d_f)


@pytest.mark.parametrize("tier", list(TIERS))
def test_merge(cw, tier):
    """merge appends the other engine's codes (ids continue) and keeps this
    engine's lists, as the JAX engine's merge does."""
    X1, X2 = _data(43, 3000, 250)
    e1, e2 = _engine(cw, tier), _engine(cw, tier)
    e1.add_configure(X1, nlist=30)
    e1._ensure_cache()
    e2.add(X2)
    e1.merge(e2)
    assert e1.N == 3250 and e1._stores is not None  # merged in O(batch)
    np.testing.assert_array_equal(e1.codes[3000:], e2.codes)
    j1 = _jax_engine(cw, tier)
    j2 = rii_tpu.Rii(rii_tpu.PQ.from_codewords(cw))
    j1.add_configure(X1, nlist=30)
    j2.add(X2)
    j1.merge(j2)
    assert e1.posting_lists == j1.posting_lists
    q = np.ascontiguousarray(X2[:8])
    ids_e, d_e = e1.query_batch(q, topk=5, method="linear")
    _assert_close_to(ids_e, d_e, *j1.query_batch(q, topk=5, method="linear"))
    assert (ids_e[:, 0] >= 3000).mean() >= 0.75
    other = Rii(PQ(M=4, Ks=32, device="cpu").fit(X1[:500], iter=2))
    with pytest.raises(AssertionError):
        e1.merge(other)
