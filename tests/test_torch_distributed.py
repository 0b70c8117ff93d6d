"""The port's ShardedRii against ``rii_tpu.parallel.ShardedRii``, end to end.

The JAX side runs on ``tests/conftest.py``'s eight CPU devices; the port on
an eight-shard CPU mesh. Both wrap engines over the same arrays (the port's
engine is built from the JAX engine's codewords, codes, centers and
assignments). The comparisons run in exact mode (``topk_recall=None``):
``rii_tpu``'s fast mode selects with ``approx_max_k``, which is not exact on
the CPU (ROADMAP queue 3). There distances agree to 1e-5 relative and ids
per rank except at ties. ``rii_tpu``'s sharded bf16 windows keep their bf16
products, where the port rescores them in float32 below Q=512 as its
single-device engine does: those comparisons set ``exact_rescore=False`` on
both engines, or compare id sets and the bf16 class. The fast mode's kernel
routes run through the kernels' plain twins (``force_kernel_routing``)."""

import numpy as np
import pytest
import torch

import rii_tpu
import rii_tpu.parallel as jpar

from rii_tpu_torch import PQ, Rii
from rii_tpu_torch.ops import ivf as port_ivf
from rii_tpu_torch.parallel import (
    ShardedRii,
    fit_on_mesh,
    make_mesh,
    make_mesh_hc,
    predict_on_mesh,
    reconfigure_on_mesh,
)

from _torch_parity import (assert_assignments_equal_but_near_ties,
                           assert_ranked_ids_match, port_engine)

RTOL = 1e-5
BF16_RTOL = 3e-2  # rii_tpu's sharded bf16 windows: bf16 products, no rescore


def _mesh(n=8):
    return make_mesh(n, device="cpu")


def _engine(n=3000, d=32, codec_cls=rii_tpu.PQ, topk_recall=None):
    X = np.random.RandomState(9).random((n, d)).astype(np.float32)
    kw = {"rotation_iter": 2} if codec_cls is rii_tpu.OPQ else {}
    je = rii_tpu.Rii(fine_quantizer=codec_cls(M=4, Ks=32).fit(X, **kw))
    je.topk_recall = topk_recall
    je.add_configure(X, nlist=30)
    return je, port_engine(je, topk_recall=topk_recall), X


def _replicas(sr):
    """Each linear chunk's bf16 replica (none on the code tiers)."""
    return [lin.replica for ls in sr.linear for lin in ls
            if lin.replica is not None]


def _sets_equal(a, b):
    for ra, rb in zip(a, b):
        assert set(ra.tolist()) == set(rb.tolist())


def test_sharded_rii_matches_engine():
    je, te, X = _engine()
    s = ShardedRii(te, mesh=_mesh())
    q = X[:16]
    ids_s, d_s = s.query_batch(q, topk=7)
    assert ids_s.dtype == np.int64 and d_s.dtype == np.float64
    ids_e, d_e = te.query_batch(q, topk=7, method="linear")
    assert_ranked_ids_match(ids_s, d_s, ids_e, d_e, rtol=RTOL)
    ids_j, d_j = jpar.ShardedRii(je).query_batch(q, topk=7)
    assert_ranked_ids_match(ids_s, d_s, ids_j, d_j, rtol=RTOL)


def test_sharded_rii_opq():
    je, te, X = _engine(codec_cls=rii_tpu.OPQ)
    s = ShardedRii(te, mesh=_mesh())
    ids_s, d_s = s.query_batch(X[:4], topk=5)
    ids_e, d_e = te.query_batch(X[:4], topk=5, method="linear")
    assert_ranked_ids_match(ids_s, d_s, ids_e, d_e, rtol=RTOL)
    ids_j, d_j = jpar.ShardedRii(je).query_batch(X[:4], topk=5)
    assert_ranked_ids_match(ids_s, d_s, ids_j, d_j, rtol=RTOL)


def test_sharded_rii_decoded_replica():
    je, te, X = _engine()
    s = ShardedRii(te, mesh=_mesh(), use_decoded=True)
    assert all(lin.form == "decoded_flat" for ls in s.linear for lin in ls)
    ids_s, d_s = s.query_batch(X[:8], topk=5)
    ids_e, d_e = te.query_batch(X[:8], topk=5, method="linear")
    assert_ranked_ids_match(ids_s, d_s, ids_e, d_e, rtol=RTOL)
    ids_j, d_j = jpar.ShardedRii(je, use_decoded=True).query_batch(X[:8], topk=5)
    assert_ranked_ids_match(ids_s, d_s, ids_j, d_j, rtol=RTOL)


def test_sharded_rii_deep1b_shape():
    """Deep1B's sub-space width (Ds=8) at D=32, N=4096, on eight shards."""
    X = np.random.RandomState(13).random((4096, 32)).astype(np.float32)
    je = rii_tpu.Rii(fine_quantizer=rii_tpu.PQ(M=4, Ks=64).fit(X[:2000]))
    je.topk_recall = None
    je.add_configure(X, nlist=64)
    te = port_engine(je, topk_recall=None)
    s = ShardedRii(te, mesh=_mesh())
    ids_s, d_s = s.query_batch(X[:8], topk=10)
    ids_j, d_j = jpar.ShardedRii(je).query_batch(X[:8], topk=10)
    assert_ranked_ids_match(ids_s, d_s, ids_j, d_j, rtol=RTOL)
    assert ids_s[0, 0] == 0


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_sharded_rii_small_mesh(ndev):
    je, te, X = _engine(n=500)
    s = ShardedRii(te, mesh=_mesh(ndev))
    assert s.ndev == ndev and s.cap % ndev == 0
    ids_s, d_s = s.query_batch(X[:4], topk=3)
    ids_j, d_j = jpar.ShardedRii(je, mesh=jpar.make_mesh(ndev)).query_batch(
        X[:4], topk=3)
    assert_ranked_ids_match(ids_s, d_s, ids_j, d_j, rtol=RTOL)


# --------------------------------------------------------------------------- #
# subset search, pq and int8 windows, growth
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def big_engine():
    rng = np.random.RandomState(5)
    n, d = 4096, 32
    X = rng.random((n, d)).astype(np.float32)
    je = rii_tpu.Rii(rii_tpu.PQ(M=4, Ks=32).fit(X[:1024], iter=3))
    je.scan_mode = "bf16"
    je.topk_recall = None
    je.add_configure(X, nlist=48, iter=3)
    te = port_engine(je, scan_mode="bf16", topk_recall=None)
    tids = np.sort(rng.choice(n, 500, replace=False)).astype(np.int64)
    return je, te, X, tids


def test_sharded_subset_linear_matches_engine(big_engine):
    je, te, X, tids = big_engine
    sr = ShardedRii(te, mesh=_mesh(), use_decoded=True)
    ids_s, d_s = sr.query_batch(X[:8], topk=5, target_ids=tids)
    ids_e, d_e = te.query_batch(X[:8], topk=5, target_ids=tids, method="linear")
    assert_ranked_ids_match(ids_s, d_s, ids_e, d_e, rtol=RTOL)
    ids_j, d_j = jpar.ShardedRii(je, use_decoded=True).query_batch(
        X[:8], topk=5, target_ids=tids)
    assert_ranked_ids_match(ids_s, d_s, ids_j, d_j, rtol=RTOL)
    assert np.isin(ids_s, tids).all()


def test_sharded_subset_ivf_full_coverage_matches_subset_linear(big_engine):
    je, te, X, tids = big_engine
    sr = ShardedRii(te, mesh=_mesh(), use_decoded=True)
    ids_l, d_l = sr.query_batch(X[:8], topk=5, target_ids=tids)
    ids_i, d_i = sr.query_ivf_batch(X[:8], topk=5, L=te.N, target_ids=tids)
    _sets_equal(ids_l, ids_i)
    np.testing.assert_allclose(np.sort(d_i, 1), np.sort(d_l, 1), rtol=RTOL)
    ids_j, d_j = jpar.ShardedRii(je, use_decoded=True).query_ivf_batch(
        X[:8], topk=5, L=je.N, target_ids=tids)
    _sets_equal(ids_i, ids_j)
    np.testing.assert_allclose(d_i, d_j, rtol=BF16_RTOL, atol=BF16_RTOL)


def test_sharded_pq_mode_ivf_matches_linear_at_full_coverage(big_engine):
    je, te, X, tids = big_engine
    sr = ShardedRii(te, mesh=_mesh(), use_decoded=False)
    assert sr.windows is not None and sr.tier == "pq"
    held = sr.windows[0].tensors()
    assert "codes_g" in held and "decoded_g" not in held  # memory-lean
    assert _replicas(sr) == []
    ids_l, d_l = sr.query_batch(X[:8], topk=10)
    ids_i, d_i = sr.query_ivf_batch(X[:8], topk=10, L=te.N)
    _sets_equal(ids_l, ids_i)
    np.testing.assert_allclose(np.sort(d_i, 1), np.sort(d_l, 1), rtol=RTOL)
    for row in ids_i:  # unique ids per row: duplicate windows stay masked
        row = row[row >= 0]
        assert len(set(row.tolist())) == len(row)
    ids_j, d_j = jpar.ShardedRii(je, use_decoded=False).query_ivf_batch(
        X[:8], topk=10, L=je.N)
    assert_ranked_ids_match(ids_i, d_i, ids_j, d_j, rtol=RTOL)


def test_sharded_pq_mode_subset_ivf():
    """pq windows, exact mode: subset IVF at full coverage gives the
    engine's exact subset linear scan and rii_tpu's answers."""
    rng = np.random.RandomState(17)
    n, d = 4096, 32
    X = rng.random((n, d)).astype(np.float32)
    je = rii_tpu.Rii(rii_tpu.PQ(M=4, Ks=32).fit(X[:1024], iter=3))
    je.scan_mode = "pq"
    je.topk_recall = None
    je.add_configure(X, nlist=48, iter=3)
    te = port_engine(je, scan_mode="pq", topk_recall=None)
    tids = np.sort(rng.choice(n, 500, replace=False)).astype(np.int64)
    sr = ShardedRii(te, mesh=_mesh(), use_decoded=False)
    ids_i, d_i = sr.query_ivf_batch(X[:8], topk=5, L=n, target_ids=tids)
    ids_e, d_e = te.query_batch(X[:8], topk=5, target_ids=tids, method="linear")
    assert_ranked_ids_match(ids_i, d_i, ids_e, d_e, rtol=RTOL)
    ids_j, d_j = jpar.ShardedRii(je, use_decoded=False).query_ivf_batch(
        X[:8], topk=5, L=n, target_ids=tids)
    assert_ranked_ids_match(ids_i, d_i, ids_j, d_j, rtol=RTOL)


def test_sharded_ivf_default_L_subset_contract(big_engine):
    je, te, X, tids = big_engine
    sr = ShardedRii(te, mesh=_mesh(), use_decoded=True)
    ids, dists = sr.query_ivf_batch(X[:4], topk=3, target_ids=tids)
    assert ids.shape == (4, 3)
    assert (np.diff(dists, axis=1) >= 0).all()
    assert np.isin(ids[ids >= 0], tids).all()


def test_sharded_add_then_query():
    rng = np.random.RandomState(21)
    X = rng.random((2048, 32)).astype(np.float32)
    X2 = rng.random((256, 32)).astype(np.float32)
    jpq = rii_tpu.PQ(M=4, Ks=32).fit(X[:512], iter=3)
    je = rii_tpu.Rii(jpq)
    je.topk_recall = None
    je.add_configure(X, nlist=32, iter=3)
    te = port_engine(je, topk_recall=None)
    sr = ShardedRii(te, mesh=_mesh())
    sr.add(X2, update_posting_lists=True)
    assert sr.engine.N == 2304 == sr._n_dev
    jsr = jpar.ShardedRii(je)
    jsr.add(X2, update_posting_lists=True)
    np.testing.assert_array_equal(te.codes, je.codes)
    q = X2[:4]
    ids_s, d_s = sr.query_batch(q, topk=5)
    ids_j, d_j = jsr.query_batch(q, topk=5)
    assert_ranked_ids_match(ids_s, d_s, ids_j, d_j, rtol=RTOL)
    # a single-device port engine fed the same operations
    e2 = Rii(PQ.from_codewords(jpq.codewords, device="cpu"))
    e2.topk_recall = None
    e2.add_configure(X, nlist=32, iter=3)
    e2.add(X2, update_posting_lists=True)
    ids_e, d_e = e2.query_batch(q, topk=5, method="linear")
    assert_ranked_ids_match(ids_s, d_s, ids_e, d_e, rtol=RTOL)


def test_sharded_rii_never_builds_single_device_cache():
    """Neither the construction nor any query (method "auto" included)
    builds the engine's single-device cache."""
    je, te, X = _engine()
    te._stores = None
    s = ShardedRii(te, mesh=_mesh())
    assert te._stores is None, "refresh() built the single-device cache"
    s.query_batch(X[:4], topk=3)
    s.query_batch(X[:4], topk=3, method="auto")
    s.query_ivf_batch(X[:4], topk=3)
    tids = np.arange(0, 1000, dtype=np.int64)
    s.query_batch(X[:4], topk=3, target_ids=tids, method="auto")
    s.add(X[:16])
    assert te._stores is None, "a sharded path built the single-device cache"


def test_sharded_auto_with_unreconfigured_engine_falls_back_linear():
    X = np.random.RandomState(41).random((1200, 32)).astype(np.float32)
    e2 = Rii(PQ(M=4, Ks=32, device="cpu").fit(X[:512], iter=3))
    e2.add(X, update_posting_lists=False)  # never reconfigured: no threshold
    s = ShardedRii(e2, mesh=_mesh())
    assert s.windows is None
    ids, _ = s.query_batch(X[:4], topk=3, method="auto")
    assert ids.shape == (4, 3)
    assert (ids[:, 0] >= 0).all()


def test_sharded_merge_matches_engine():
    rng = np.random.RandomState(37)
    X = rng.random((2000, 32)).astype(np.float32)
    Y = rng.random((500, 32)).astype(np.float32)
    pq = PQ(M=4, Ks=32, device="cpu").fit(X[:512], iter=3)
    e1 = Rii(pq)
    e1.topk_recall = None
    e1.add_configure(X, nlist=24, iter=3)
    other = Rii(pq)
    other.add(Y, update_posting_lists=False)
    sr = ShardedRii(e1, mesh=_mesh())
    sr.merge(other)
    assert sr.engine.N == 2500 == sr._n_dev

    e2 = Rii(pq)
    e2.topk_recall = None
    e2.add_configure(X, nlist=24, iter=3)
    e2.merge(other)
    ids_s, d_s = sr.query_batch(Y[:4], topk=5)
    ids_e, d_e = e2.query_batch(Y[:4], topk=5, method="linear")
    assert_ranked_ids_match(ids_s, d_s, ids_e, d_e, rtol=RTOL)
    assert (ids_s[:, 0] >= 2000).all()


# --------------------------------------------------------------------------- #
# the distributed reconfigure
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def recon_data():
    rng = np.random.RandomState(23)
    X = rng.random((3000, 32)).astype(np.float32)
    jpq = rii_tpu.PQ(M=4, Ks=32).fit(X[:1024], iter=3)
    codes = jpq.encode(X)
    single = Rii(PQ.from_codewords(jpq.codewords, device="cpu"))
    single.add_codes(codes, update_posting_lists=False)
    single.reconfigure(nlist=40, iter=4)
    return jpq, codes, single


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_sharded_reconfigure_bit_identical_to_single_device(recon_data, ndev):
    """Meshes whose size divides the eight canonical reduction groups give
    the single-device build's centers and posting lists, bit for bit."""
    jpq, codes, single = recon_data
    e = Rii(PQ.from_codewords(jpq.codewords, device="cpu"))
    e.add_codes(codes, update_posting_lists=False)
    sr = ShardedRii(e, mesh=_mesh(ndev))
    sr.reconfigure(nlist=40, iter=4)
    np.testing.assert_array_equal(e.coarse_centers, single.coarse_centers)
    assert e.posting_lists == single.posting_lists
    assert sr.windows is not None and e.threshold is not None
    assert set(e.last_reconfigure_stats) >= {"fit_s", "predict_s"}


def test_reconfigure_on_mesh_matches_rii_tpu(recon_data):
    """The port's mesh build against rii_tpu's reconfigure_on_mesh on the
    same codes: equal centers, and posting lists equal but where an
    assignment's two nearest centers tie in float32."""
    jpq, codes, _ = recon_data
    je = rii_tpu.Rii(jpq)
    je.add_codes(codes, update_posting_lists=False)
    jpar.reconfigure_on_mesh(je, jpar.make_mesh(), nlist=40, iter=4)
    e = Rii(PQ.from_codewords(jpq.codewords, device="cpu"))
    e.add_codes(codes, update_posting_lists=False)
    reconfigure_on_mesh(e, _mesh(), nlist=40, iter=4)
    np.testing.assert_array_equal(e.coarse_centers, je.coarse_centers)
    assert_assignments_equal_but_near_ties(jpq.codewords, codes,
                                           je.coarse_centers,
                                           e._assignments(), je._assignments())


def test_fit_and_predict_on_mesh_match_single_device(recon_data):
    from rii_tpu_torch.models.pqkmeans import pqkmeans_fit, pqkmeans_predict
    jpq, codes, _ = recon_data
    c1, a1 = pqkmeans_fit(jpq.codewords, codes[:1500], k=20, iters=3,
                          device="cpu")
    c2, a2 = fit_on_mesh(_mesh(4), jpq.codewords, codes[:1500], k=20, iters=3)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)
    p1 = pqkmeans_predict(jpq.codewords, c1, codes, device="cpu")
    p2 = predict_on_mesh(_mesh(8), jpq.codewords, c1, codes, block=256)
    np.testing.assert_array_equal(p1, p2)
    assert predict_on_mesh(_mesh(2), jpq.codewords, c1, codes[:0]).shape == (0,)


# --------------------------------------------------------------------------- #
# coverage of the global probe selection
# --------------------------------------------------------------------------- #

def test_sharded_ivf_narrow_budget_on_skewed_layout():
    """A narrow candidate budget (L ~ 5% of N) on a skewed cluster layout
    still recovers most of the exact top-k, and answers as rii_tpu does."""
    rng = np.random.RandomState(31)
    sizes = np.array([600] * 4 + [150] * 8 + [30] * 12)
    n, d = int(sizes.sum()), 32
    centers = rng.normal(0, 1, (24, d)).astype(np.float32)
    X = np.ascontiguousarray(np.concatenate([
        centers[c] + 0.15 * rng.normal(0, 1, (s, d)).astype(np.float32)
        for c, s in enumerate(sizes)]), dtype=np.float32)
    je = rii_tpu.Rii(rii_tpu.PQ(M=4, Ks=64).fit(
        X[rng.choice(n, 1024, replace=False)], iter=5))
    je.scan_mode = "bf16"
    je.topk_recall = None
    je.add_configure(X, nlist=24, iter=5)
    te = port_engine(je, scan_mode="bf16", topk_recall=None)
    sr = ShardedRii(te, mesh=_mesh(), use_decoded=True)
    q = X[rng.choice(n, 16, replace=False)]
    L = max(10, int(0.05 * n))
    ids_exact, _ = sr.query_batch(q, topk=10)
    ids_ivf, d_ivf = sr.query_ivf_batch(q, topk=10, L=L)
    recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                      for a, b in zip(ids_ivf, ids_exact)])
    assert recall >= 0.8, recall
    ids_j, d_j = jpar.ShardedRii(je, use_decoded=True).query_ivf_batch(
        q, topk=10, L=L)
    np.testing.assert_allclose(d_ivf, d_j, rtol=BF16_RTOL, atol=BF16_RTOL)


def _adversarial():
    rng = np.random.RandomState(41)
    d = 32
    hot = rng.normal(0, 0.05, (2000, d)).astype(np.float32)
    far = 10 + rng.normal(0, 1, (98, d)).astype(np.float32)
    cold = np.concatenate([c + 0.05 * rng.normal(0, 1, (388, d)).astype(np.float32)
                           for c in far])
    X = np.ascontiguousarray(np.concatenate([hot, cold]), np.float32)
    je = rii_tpu.Rii(rii_tpu.PQ(M=4, Ks=64).fit(
        X[rng.choice(len(X), 2048, replace=False)], iter=5))
    je.scan_mode = "bf16"
    je.topk_recall = None
    je.add_configure(X, nlist=100, iter=5)
    q = np.ascontiguousarray(hot[rng.choice(2000, 8, replace=False)])
    return je, q


@pytest.mark.parametrize("tier", [True, "i8", False])
def test_sharded_ivf_deterministic_coverage_adversarial_concentration(tier):
    """Every hot window on one or two shards: the global probe selection
    still scans all of them, so a narrow-budget IVF query whose top-k lies
    in the hot cluster returns the exact linear answers (each tier rescores
    in float32 here), and rii_tpu's ids."""
    je, q = _adversarial()
    te = port_engine(je, scan_mode="bf16", topk_recall=None)
    sr = ShardedRii(te, mesh=_mesh(), use_decoded=tier)
    ws = sr.windows[0]
    wv = 8  # pow2(round(100 * nlist_v / N) + slack) at this shape
    assert 2 * min(8 * wv, ws.nlist_v) * ws.cap_v < sr.cap  # no fallback
    hot = torch.nonzero(torch.cat([w.centers_norms_v for w in sr.windows])
                        < 1).flatten()
    assert len({int(v) // ws.n_win for v in hot}) <= 2  # hot shards
    ids_lin, d_lin = sr.query_batch(q, topk=10)
    ids_ivf, d_ivf = sr.query_ivf_batch(q, topk=10, L=100)
    assert_ranked_ids_match(ids_ivf, d_ivf, ids_lin, d_lin, rtol=RTOL)
    # the hot cluster's rows share a few codes, so hundreds of rows tie at
    # each distance and the packages' ids among them differ: distances only
    _, d_j = jpar.ShardedRii(je, use_decoded=tier).query_ivf_batch(
        q, topk=10, L=100)
    rtol = BF16_RTOL if tier is True else RTOL
    np.testing.assert_allclose(d_ivf, d_j, rtol=rtol, atol=rtol)


def test_sharded_2d_hosts_chips_mesh_matches_engine():
    """A 2-D (hosts, chips) mesh merges each host's chips, then the hosts;
    linear, subset and full-coverage IVF answers equal the 1-D mesh's and
    rii_tpu's on its 2-D mesh."""
    je, te, X = _engine(n=4000)
    mesh = make_mesh_hc(n_hosts=2, n_chips=4, device="cpu")
    assert mesh.axis_names == ("hosts", "chips") and mesh.size == 8
    s = ShardedRii(te, mesh=mesh)
    s1 = ShardedRii(te, mesh=_mesh())
    js = jpar.ShardedRii(je, mesh=jpar.make_mesh_hc(n_hosts=2, n_chips=4))
    q = X[:16]
    tids = np.sort(np.random.RandomState(3).choice(
        te.N, 900, replace=False)).astype(np.int64)
    for kw in ({}, {"target_ids": tids}):
        ids_s, d_s = s.query_batch(q, topk=7, **kw)
        ids_1, d_1 = s1.query_batch(q, topk=7, **kw)
        ids_j, d_j = js.query_batch(q, topk=7, **kw)
        assert_ranked_ids_match(ids_s, d_s, ids_1, d_1, rtol=RTOL)
        assert_ranked_ids_match(ids_s, d_s, ids_j, d_j, rtol=RTOL)
    ids_i, d_i = s.query_ivf_batch(q[:8], topk=5, L=te.N)
    ids_e, d_e = te.query_batch(q[:8], topk=5, method="linear")
    assert_ranked_ids_match(ids_i, d_i, ids_e, d_e, rtol=RTOL)


@pytest.mark.parametrize("chunks", [2, 3, 4])
def test_sharded_overlap_chunks_identical_results(chunks):
    """Splitting each shard's linear scan into chunks changes no answer."""
    rng = np.random.RandomState(17)
    X = rng.random((8192, 32)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=32, device="cpu").fit(X[:2000]))
    e.topk_recall = None
    e.add_configure(X, nlist=64)
    # headroom 3 makes cap 32768: 4096 rows a shard, four 1024-row chunks
    sc = ShardedRii(e, mesh=_mesh(), overlap_chunks=chunks, growth_headroom=3.0)
    s1 = ShardedRii(e, mesh=_mesh(), overlap_chunks=1, growth_headroom=3.0)
    assert sc.nchunks == (chunks if chunks != 3 else 2) and s1.nchunks == 1
    tids = np.sort(rng.choice(8192, 3000, replace=False)).astype(np.int64)
    for kw in ({}, {"target_ids": tids}):
        ids_c, d_c = sc.query_batch(X[:8], topk=10, **kw)
        ids_1, d_1 = s1.query_batch(X[:8], topk=10, **kw)
        np.testing.assert_array_equal(ids_c, ids_1)
        np.testing.assert_array_equal(d_c, d_1)
        ids_e, d_e = e.query_batch(X[:8], topk=10, method="linear", **kw)
        assert_ranked_ids_match(ids_c, d_c, ids_e, d_e, rtol=RTOL)


def test_sharded_i8_window_mode_matches_linear_at_full_coverage():
    """use_decoded="i8": int8 windows (kernel G's twin here) with a float32
    rescore from the grouped codes; full-coverage IVF gives the exact linear
    answers and rii_tpu's (its Pallas kernel in interpret mode)."""
    rng = np.random.RandomState(19)
    n, d = 4096, 32
    X = rng.random((n, d)).astype(np.float32)
    je = rii_tpu.Rii(rii_tpu.PQ(M=4, Ks=32).fit(X[:1024], iter=3))
    je.scan_mode = "pq"
    je.topk_recall = None
    je.add_configure(X, nlist=48, iter=3)
    te = port_engine(je, scan_mode="pq", topk_recall=None)
    sr = ShardedRii(te, mesh=_mesh(), use_decoded="i8")
    assert sr.tier == "int8" and _replicas(sr) == []
    held = sr.windows[0].tensors()
    assert "decoded_g_i8" in held and "codes_g" in held
    jsr = jpar.ShardedRii(je, use_decoded="i8")
    np.testing.assert_array_equal(
        torch.cat([w.rows for w in sr.windows]).numpy(),
        np.asarray(jsr.ivf["decoded_g_i8"]))
    ids_l, d_l = sr.query_batch(X[:8], topk=10)
    ids_i, d_i = sr.query_ivf_batch(X[:8], topk=10, L=n)
    assert_ranked_ids_match(ids_i, d_i, ids_l, d_l, rtol=RTOL)
    ids_j, d_j = jsr.query_ivf_batch(X[:8], topk=10, L=n)
    assert_ranked_ids_match(ids_i, d_i, ids_j, d_j, rtol=RTOL)
    tids = np.sort(rng.choice(n, 500, replace=False)).astype(np.int64)
    ids_s, d_s = sr.query_ivf_batch(X[:8], topk=5, L=n, target_ids=tids)
    ids_sl, d_sl = sr.query_batch(X[:8], topk=5, target_ids=tids)
    assert_ranked_ids_match(ids_s, d_s, ids_sl, d_sl, rtol=RTOL)
    ids_sj, d_sj = jsr.query_ivf_batch(X[:8], topk=5, L=n, target_ids=tids)
    assert_ranked_ids_match(ids_s, d_s, ids_sj, d_sj, rtol=RTOL)


def test_bf16_windows_without_rescore_match_rii_tpu(big_engine):
    """With exact_rescore=False neither package rescores: the bf16 windows'
    bf16-product distances agree to float32 rounding."""
    je, te, X, tids = big_engine
    je.exact_rescore = te.exact_rescore = False
    try:
        sr = ShardedRii(te, mesh=_mesh(), use_decoded=True)
        jsr = jpar.ShardedRii(je, use_decoded=True)
        for kw in ({}, {"target_ids": tids}):
            ids_i, d_i = sr.query_ivf_batch(X[:8], topk=5, L=te.N, **kw)
            ids_j, d_j = jsr.query_ivf_batch(X[:8], topk=5, L=je.N, **kw)
            assert_ranked_ids_match(ids_i, d_i, ids_j, d_j, rtol=RTOL)
            ids_i, d_i = sr.query_batch(X[:8], topk=5, **kw)
            ids_j, d_j = jsr.query_batch(X[:8], topk=5, **kw)
            assert_ranked_ids_match(ids_i, d_i, ids_j, d_j, rtol=RTOL)
    finally:
        je.exact_rescore = te.exact_rescore = "auto"


# --------------------------------------------------------------------------- #
# the fast mode's kernel routes, through the kernels' plain twins
# --------------------------------------------------------------------------- #

def _clustered(seed=43):
    """N=32768 rows in 128 well-separated clusters of 256 (D=32), nlist=128:
    at L=100 a batch of 8 probes 64 of ~256 windows, under half the
    capacity, so IVF runs the window scan (no linear fallback)."""
    rng = np.random.RandomState(seed)
    centers = rng.normal(0, 1, (128, 32)).astype(np.float32)
    X = np.repeat(centers, 256, axis=0) + 0.3 * rng.normal(0, 1, (32768, 32))
    # rows in random order: a cluster's rows do not share replica tiles
    X = np.ascontiguousarray(X[rng.permutation(32768)], np.float32)
    e = Rii(PQ(M=8, Ks=64, device="cpu").fit(X[rng.choice(32768, 4096)], iter=3))
    e.scan_mode = "bf16"
    e.add_configure(X, nlist=128, iter=3)
    q = (X[rng.choice(32768, 8, replace=False)]
         + rng.normal(0, 0.02, (8, 32))).astype(np.float32)
    return e, X, q


@pytest.mark.parametrize("tier", [True, "i8", False])
def test_kernel_routes_through_twins(tier, monkeypatch):
    """force_kernel_routing: the bf16 tier scans each shard's transposed
    replica chunks (kernel A's twin) and its windows with kernel B's twin;
    the int8 windows take G's, the pq windows E's (Q < D). Answers: the
    exact mode's at rank 1 and nine in ten of the top 10 (the window
    kernels keep two candidates an 8-slot tile), distances rescored in
    float32."""
    e, X, q = _clustered()
    e.force_kernel_routing = True
    calls = {}
    for name in ("ivf_window_tile_minima", "ivf_i8_window_tile_minima",
                 "ivf_dt_window_tile_minima", "ivf_pq_window_tile_minima"):
        real = getattr(port_ivf, name)
        monkeypatch.setattr(port_ivf, name, lambda *a, _r=real, _n=name, **k:
                            calls.__setitem__(_n, calls.get(_n, 0) + 1) or _r(*a, **k))
    fast = ShardedRii(e, mesh=_mesh(), use_decoded=tier)
    e.topk_recall = None
    exact = ShardedRii(e, mesh=_mesh(), use_decoded=tier)
    e.topk_recall = 0.99
    assert (fast.linear[0][0].form == "decoded_t") == (tier is True)
    assert exact.linear[0][0].form != "decoded_t"
    assert fast.cap % (8 * (16384 if tier is True else 1024)) == 0
    ws = fast.windows[0]
    assert 2 * 64 * ws.cap_v < fast.cap and ws.nlist_v > 64
    for method in ("linear", "ivf"):
        calls.clear()
        ids_f, d_f = fast.query_batch(q, topk=10, L=100, method=method)
        n_calls = dict(calls)
        ids_x, d_x = exact.query_batch(q, topk=10, L=100, method=method)
        # rank 1 (rows with equal codes tie)
        np.testing.assert_allclose(d_f[:, 0], d_x[:, 0], rtol=RTOL)
        for r in range(len(q)):
            assert ids_f[r, 0] in ids_x[r][np.isclose(d_x[r], d_f[r, 0], rtol=RTOL)]
        # recall by distance (ties make the id sets arbitrary)
        hit = np.mean(d_f <= d_x[:, -1:] * (1 + RTOL))
        assert hit >= 0.9, (method, hit)
    want = {True: "ivf_window_tile_minima", "i8": "ivf_i8_window_tile_minima",
            False: "ivf_dt_window_tile_minima"}[tier]
    assert n_calls == {want: 8}, n_calls  # once a shard
    # the returned distances are the exact ADC of the returned ids
    cw = e.codewords
    for r in range(len(q)):
        dec = cw[np.arange(8)[None, :], e.codes[ids_f[r]].astype(np.int64)]
        ref = ((dec.reshape(10, -1) - q[r]) ** 2).sum(1)
        np.testing.assert_allclose(d_f[r], ref, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# O(batch) delta adds on the mesh
# --------------------------------------------------------------------------- #

def _delta_engine(rng, n, d=32, nlist=32):
    X = rng.random((n + 1024, d)).astype(np.float32)
    pq = PQ(M=4, Ks=32, device="cpu").fit(X[:512], iter=3)
    e = Rii(pq)
    e.topk_recall = None
    e.add_configure(X[:n], nlist=nlist, iter=3)
    return e, X


@pytest.mark.parametrize("tier", [None, True, "i8", False])
def test_sharded_delta_add_no_rebuild_matches_full_refresh(tier):
    """add() scatters into the live shards (the same tensors, in place: no
    refresh) and then answers as a freshly refreshed ShardedRii over the
    same engine."""
    rng = np.random.RandomState(33)
    e, X = _delta_engine(rng, 2048)
    sr = ShardedRii(e, mesh=_mesh(), use_decoded=tier)
    q = np.ascontiguousarray(X[100:108])
    sr.query_batch(q, topk=5)
    held = (sr.codes + sr.norms + [w.order_g for w in sr.windows]
            + [w.codes_g for w in sr.windows] + _replicas(sr))
    ptrs = [t.data_ptr() for t in held]
    n0, cap0 = e.N, sr.cap

    sr.add(X[2048:2048 + 256], update_posting_lists=True)

    assert sr._n_dev == n0 + 256 and sr.cap == cap0
    assert sr._engine_version == e._version
    now = (sr.codes + sr.norms + [w.order_g for w in sr.windows]
           + [w.codes_g for w in sr.windows] + _replicas(sr))
    assert all(a is b for a, b in zip(now, held)), "the shards were rebuilt"
    assert [t.data_ptr() for t in now] == ptrs
    ref = ShardedRii(e, mesh=_mesh(), use_decoded=tier)
    for kw in ({}, {"target_ids": np.sort(np.concatenate([
            rng.choice(2048, 200, replace=False),
            2048 + rng.choice(256, 56, replace=False)])).astype(np.int64)}):
        ids_a, d_a = sr.query_batch(q, topk=10, **kw)
        ids_b, d_b = ref.query_batch(q, topk=10, **kw)
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_allclose(d_a, d_b, rtol=1e-6)
        ids_a, d_a = sr.query_ivf_batch(q, topk=10, L=e.N, **kw)
        ids_b, d_b = ref.query_ivf_batch(q, topk=10, L=e.N, **kw)
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_allclose(d_a, d_b, rtol=1e-6)
    for key in ("v_counts", "v_vstart", "v_capacity"):
        np.testing.assert_array_equal(getattr(sr.windows[0], key),
                                      getattr(ref.windows[0], key))
    # every scattered tensor equals the rebuilt one
    for key in ("order_g", "norms_g", "codes_g", "decoded_g", "decoded_g_i8",
                "vlen_g"):
        held = [w.tensors().get(key) for w in ref.windows]
        if held[0] is not None:
            assert torch.equal(torch.cat([w.tensors()[key] for w in sr.windows]),
                               torch.cat(held)), key
    for a, b in ((sr.codes, ref.codes), (sr.norms, ref.norms),
                 (_replicas(sr), _replicas(ref))):
        if b:
            assert torch.equal(torch.cat(a), torch.cat(b))
    qn = np.ascontiguousarray(X[2048:2052])
    ids_n, _ = sr.query_ivf_batch(qn, topk=1, L=e.N)
    assert (ids_n[:, 0] >= 2048).all()


def test_sharded_delta_add_without_update_invisible_to_ivf():
    rng = np.random.RandomState(34)
    e, X = _delta_engine(rng, 2048)
    sr = ShardedRii(e, mesh=_mesh())
    sr.add(X[2048:2048 + 128], update_posting_lists=False)
    assert sr._n_dev == 2048 + 128
    qn = np.ascontiguousarray(X[2048:2052])
    ids_l, _ = sr.query_batch(qn, topk=1)
    assert (ids_l[:, 0] >= 2048).all()  # linear sees the new rows
    # the windows hold only the original members
    assert int(sr.windows[0].v_counts.sum()) == 2048
    assert int(torch.cat([w.order_g for w in sr.windows]).max()) < 2048


def test_sharded_delta_add_overflow_falls_back_to_refresh():
    rng = np.random.RandomState(35)
    e, X = _delta_engine(rng, 2048)
    sr = ShardedRii(e, mesh=_mesh(), growth_headroom=0.0)
    cap0 = sr.cap
    big = rng.random((cap0 - e.N + 64, 32)).astype(np.float32)
    sr.add(big, update_posting_lists=True)
    assert sr.cap >= e.N > cap0
    assert sr._n_dev == e.N
    ref = ShardedRii(e, mesh=_mesh())
    q = np.ascontiguousarray(X[:8])
    ids_a, d_a = sr.query_batch(q, topk=5)
    ids_b, d_b = ref.query_batch(q, topk=5)
    np.testing.assert_array_equal(ids_a, ids_b)
