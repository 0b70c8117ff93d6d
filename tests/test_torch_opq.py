"""OPQ in the port (rii_tpu_torch.models.opq, and the engine's rotation of
the queries) against rii_tpu's OPQ.

Both packages share rii_tpu's fitted codewords and rotation through
``from_codewords`` (rii_tpu's fit draws from jax.random). ``rotate`` agrees
to 1e-5 relative and 1e-6 absolute (rii_tpu's product is a float32 dot at
Precision.HIGHEST, the port's a float32 matmul: the sums round in other
orders); ``encode`` may differ only at near-ties of the argmin. The port's
own fit is held by its quantization error, as tests/test_codec.py holds
rii_tpu's."""

import numpy as np
import pytest

import rii_tpu
from rii_tpu_torch import OPQ, PQ, Rii
from rii_tpu_torch.utils.convert import engine_from_arrays

from _torch_parity import NEAR_TIE_RTOL, assert_ranked_ids_match

N, D, M, KS, NLIST = 3000, 32, 4, 16, 30
ROT_RTOL, ROT_ATOL = 1e-5, 1e-6
# exact mode; the rotated queries differ by the rotation's rounding (1e-7
# relative), which the distances (||q||^2 ~ 10 against distances ~ 1) carry
# at ~1e-6
ENGINE_RTOL = 1e-5


def _correlated(n, d, seed):
    rng = np.random.RandomState(seed)
    mix = rng.normal(0, 1, (d, d)).astype(np.float32)
    mix[:, d // 2:] *= 0.1  # anisotropic spectrum
    return (rng.normal(0, 1, (n, d)).astype(np.float32) @ mix).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    X = np.random.RandomState(3).random((N, D)).astype(np.float32)
    jopq = rii_tpu.OPQ(M=M, Ks=KS).fit(X[:1000], iter=3, rotation_iter=2)
    topq = OPQ.from_codewords(jopq.codewords, jopq.rotation_matrix, device="cpu")
    Q = (X[:16] + np.random.RandomState(4).normal(0, 0.01, (16, D))).astype(np.float32)
    return dict(X=X, jopq=jopq, topq=topq, Q=Q)


def test_rotate_matches_jax(setup):
    X, jopq, topq = setup["X"], setup["jopq"], setup["topq"]
    np.testing.assert_allclose(topq.rotate(X), jopq.rotate(X),
                               rtol=ROT_RTOL, atol=ROT_ATOL)
    single = topq.rotate(X[5])
    assert single.shape == (D,) and single.dtype == np.float32
    np.testing.assert_allclose(single, jopq.rotate(X[5]), rtol=ROT_RTOL,
                               atol=ROT_ATOL)


def test_encode_matches_jax_but_near_ties(setup):
    X, jopq, topq = setup["X"], setup["jopq"], setup["topq"]
    cj, ct = jopq.encode(X), topq.encode(X)
    assert ct.dtype == np.uint8 and ct.shape == (N, M)
    rows, subs = np.nonzero(cj != ct)
    if rows.size:
        xr = np.asarray(jopq.rotate(X[rows]), np.float64).reshape(len(rows), M, -1)
        cw = np.asarray(jopq.codewords, np.float64)
        x = xr[np.arange(len(rows)), subs]
        dj = ((x - cw[subs, cj[rows, subs]]) ** 2).sum(-1)
        dt = ((x - cw[subs, ct[rows, subs]]) ** 2).sum(-1)
        rel = np.abs(dj - dt) / np.maximum(dj, 1e-30)
        assert (rel < NEAR_TIE_RTOL).all(), rel
    assert (cj == ct).mean() > 0.999
    # decode is in the rotated space, as rii_tpu's (and nanopq's)
    np.testing.assert_array_equal(topq.decode(cj), jopq.decode(cj))


def test_eq(setup):
    jopq, topq = setup["jopq"], setup["topq"]
    same = OPQ.from_codewords(jopq.codewords, jopq.rotation_matrix, device="cpu")
    assert topq == same
    assert topq != PQ.from_codewords(jopq.codewords, device="cpu")
    other = OPQ.from_codewords(jopq.codewords, np.eye(D, dtype=np.float32),
                               device="cpu")
    assert topq != other
    assert OPQ(M=4, Ks=16, device="cpu") == OPQ(M=4, Ks=16, device="cpu")
    assert OPQ(M=4, Ks=16, device="cpu") != topq
    with pytest.raises(AssertionError):
        OPQ.from_codewords(jopq.codewords, np.eye(D + 4, dtype=np.float32),
                           device="cpu")


def test_own_fit_error_below_pq():
    X = _correlated(4000, 32, 0)
    pq = PQ(M=8, Ks=32, device="cpu").fit(X, iter=5)
    opq = OPQ(M=8, Ks=32, device="cpu").fit(X, iter=5, rotation_iter=5)
    rot = opq.rotation_matrix
    np.testing.assert_allclose(rot @ rot.T, np.eye(32), atol=1e-4)
    err_pq = np.mean((pq.decode(pq.encode(X)) - X) ** 2)
    Xr = opq.rotate(X)
    err_opq = np.mean((opq.decode(opq.encode(X)) - Xr) ** 2)
    assert err_opq < err_pq, (err_opq, err_pq)


def test_own_fit_subsample_is_seeded():
    X = _correlated(1200, 16, 1)
    a = OPQ(M=4, Ks=16, device="cpu").fit(X, iter=2, rotation_iter=2,
                                         rotation_sample=500)
    b = OPQ(M=4, Ks=16, device="cpu").fit(X, iter=2, rotation_iter=2,
                                         rotation_sample=500)
    assert a == b
    c = OPQ(M=4, Ks=16, device="cpu").fit(X, iter=2, rotation_iter=2,
                                         rotation_sample=500, seed=7)
    assert not np.array_equal(a.rotation_matrix, c.rotation_matrix)


@pytest.fixture(scope="module")
def engines(setup):
    X, jopq = setup["X"], setup["jopq"]
    je = rii_tpu.Rii(jopq)
    je.topk_recall = None
    je.add_configure(X, nlist=NLIST, iter=3)
    te = engine_from_arrays(je.codewords, je.codes, je.coarse_centers,
                            je._assignments(), device="cpu",
                            rotation_matrix=jopq.rotation_matrix)
    te.topk_recall = None
    assert isinstance(te.fine_quantizer, OPQ)
    return je, te


@pytest.mark.parametrize("method", ["linear", "ivf"])
@pytest.mark.parametrize("subset", [None, 1000])
def test_engine_matches_jax(setup, engines, method, subset):
    je, te = engines
    tids = None if subset is None else np.sort(np.random.RandomState(8).choice(
        N, subset, replace=False)).astype(np.int64)
    ij, dj = je.query_batch(setup["Q"], topk=10, method=method, target_ids=tids,
                            L=400)
    it, dt = te.query_batch(setup["Q"], topk=10, method=method, target_ids=tids,
                            L=400)
    assert_ranked_ids_match(it, dt, ij, dj, ENGINE_RTOL)


def test_low_level_entries_take_rotated_queries(setup, engines):
    _, te = engines
    q = setup["Q"][0]
    qr = te.fine_quantizer.rotate(q)
    i1, d1 = te.query(q, topk=5, method="linear")
    i2, d2 = te.query_linear(qr, topk=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    i3, d3 = te.query(q, topk=5, method="ivf", L=400)
    i4, d4 = te.query_ivf(qr, topk=5, target_ids=None, L=400)
    np.testing.assert_array_equal(i3, i4)
    np.testing.assert_allclose(d3, d4, rtol=1e-6)


@pytest.mark.parametrize("codec_cls", [PQ, OPQ])
def test_add_and_reconfigure(codec_cls):
    """tests/test_rii.py's test_add and test_reconfigure, on the port."""
    X = np.random.RandomState(123).random((1000, 40)).astype(np.float32)
    e = Rii(codec_cls(M=4, Ks=20, device="cpu").fit(X, iter=3))
    e.add(X, update_posting_lists=False)
    assert e.N == 1000
    np.testing.assert_array_equal(e.codes, e.fine_quantizer.encode(X))
    for nlist in (5, 100):
        e.reconfigure(nlist=nlist)
        assert e.coarse_centers.shape == (nlist, 4)
        assert sum(len(pl) for pl in e.posting_lists) == 1000


@pytest.mark.parametrize("codec_cls", [PQ, OPQ])
def test_query(codec_cls):
    """tests/test_rii.py's test_query, on the port."""
    X = np.random.RandomState(123).random((1000, 40)).astype(np.float32)
    e = Rii(codec_cls(M=20, Ks=256, device="cpu").fit(X, iter=3))
    e.add_configure(X, nlist=20)
    for n, q in enumerate(X[:10]):
        ids1, dists1 = e.query(q=q, topk=50)
        assert ids1.dtype == np.int64 and dists1.dtype == np.float64
        assert np.all(0 <= np.diff(dists1))
        assert n in ids1
        ids2, dists2 = e.query(q=q, topk=50,
                               target_ids=np.arange(1000, dtype=np.int64))
        np.testing.assert_array_equal(ids1, ids2)
        np.testing.assert_allclose(dists1, dists2)
        S = np.array([2, 24, 43, 55, 102, 139, 221, 542, 667, 873, 874, 899],
                     dtype=np.int64)
        ids3, _ = e.query(q=q, topk=5, target_ids=S)
        assert all(i in S for i in ids3)
