"""The port's numpy oracle of the reference's exact walk
(rii_tpu_torch.utils.oracle) against rii_tpu's, and the port's engine held
to it: the counterpart of tests/test_oracle_parity.py and of the cases of
tests/test_rescore.py that read the oracle.

The oracle functions must give rii_tpu's outputs bit for bit. The engine,
whose windows cover a superset of the reference's walk at equal L, must
dominate the walk per rank (its i-th distance <= the oracle's i-th times
(1 + 1e-4) plus 1e-6) in the default and exact modes; on the kernel routes
(the port through its kernels' twins, rii_tpu through Pallas interpret
mode) the share of dominated ranks must equal rii_tpu's within one rank of
Q * topk."""

import numpy as np
import pytest

import rii_tpu
from rii_tpu.utils import oracle as JO
from rii_tpu_torch import PQ, Rii
from rii_tpu_torch.utils import oracle as TO

from _torch_parity import port_engine

# ---- the oracle functions, bit for bit ----------------------------------

N_SMALL, NLIST_SMALL, M_SMALL, KS_SMALL, DS_SMALL = 800, 40, 4, 16, 2


def _small(kind):
    """Codewords, codes, coarse centers, posting lists and a query: uniform
    codes, or codes drawn around 6 patterns (many equal codes)."""
    rng = np.random.RandomState(11 if kind == "uniform" else 12)
    cw = rng.normal(0, 1, (M_SMALL, KS_SMALL, DS_SMALL)).astype(np.float32)
    if kind == "uniform":
        codes = rng.randint(0, KS_SMALL, (N_SMALL, M_SMALL)).astype(np.uint8)
    else:
        pats = rng.randint(0, KS_SMALL, (6, M_SMALL))
        codes = pats[rng.randint(0, 6, N_SMALL)]
        flip = rng.random_sample(codes.shape) < 0.1
        codes = np.where(flip, rng.randint(0, KS_SMALL, codes.shape), codes)
        codes = codes.astype(np.uint8)
    centers = rng.randint(0, KS_SMALL, (NLIST_SMALL, M_SMALL)).astype(np.uint8)
    assign = rng.randint(0, NLIST_SMALL, N_SMALL)
    lists = [np.nonzero(assign == c)[0].tolist() for c in range(NLIST_SMALL)]
    q = rng.normal(0, 1, M_SMALL * DS_SMALL).astype(np.float32)
    return cw, codes, centers, lists, q


def _half_lists(cw, centers, q):
    """Posting lists whose five nearest lists (in probe order) hold two ids
    each, the other 790 ids spread over the rest: at L=50 the walk's width
    is round(50 * 40 / 800) + 3 = round(2.5) + 3 = 5 (Python rounds .5 to
    even), so the walk stops after those five lists with exactly 10 ids."""
    order = np.argsort(JO.adc_np(JO.dtable_np(q, cw), centers), kind="stable")
    rng = np.random.RandomState(13)
    ids = rng.permutation(N_SMALL)
    lists = [[] for _ in range(NLIST_SMALL)]
    for j, c in enumerate(order[:5]):
        lists[c] = sorted(ids[2 * j: 2 * j + 2].tolist())
    rest = ids[10:]
    far = rng.randint(0, NLIST_SMALL - 5, rest.size)
    for j, c in enumerate(order[5:]):
        lists[c] = sorted(rest[far == j].tolist())
    return lists, set(ids[:10].tolist())


# (name, topk, L, subset size or None)
_CASES = [
    ("full", 10, 50, None),          # the walk stops at exactly L
    ("subset", 10, 30, 120),
    ("exhausted", 10, 100, 5),       # 5 ids in all: the empty return
    ("topk_above_L", 10, 5, None),   # stops at L=5 < topk
    ("topk_above_subset", 20, 15, 15),
]


@pytest.mark.parametrize("kind", ["uniform", "clustered"])
@pytest.mark.parametrize("name,topk,L,subset", _CASES)
def test_oracle_walk_bit_equal(kind, name, topk, L, subset):
    cw, codes, centers, lists, q = _small(kind)
    tids = None
    if subset is not None:
        tids = np.sort(np.random.RandomState(3).choice(N_SMALL, subset,
                                                       replace=False))
    ij, dj = JO.query_ivf_oracle(q, topk, L, cw, centers, lists, codes, tids)
    it, dt = TO.query_ivf_oracle(q, topk, L, cw, centers, lists, codes, tids)
    assert it.dtype == np.int64 and dt.dtype == np.float64
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    if name == "exhausted":
        assert it.size == 0
    elif name.startswith("topk_above"):
        assert 0 < it.size < topk
    else:
        assert it.size == topk
    lj = JO.query_linear_oracle(q, topk, cw, codes, tids)
    lt = TO.query_linear_oracle(q, topk, cw, codes, tids)
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["uniform", "clustered"])
def test_oracle_width_rounds_half_to_even(kind):
    cw, codes, centers, _, q = _small(kind)
    lists, first_ten = _half_lists(cw, centers, q)
    ij, dj = JO.query_ivf_oracle(q, 10, 50, cw, centers, lists, codes)
    it, dt = TO.query_ivf_oracle(q, 10, 50, cw, centers, lists, codes)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    # w = 5: exactly the ten ids of the first five lists (w = 6 would add
    # the sixth list's and keep the ten nearest of more)
    assert set(it.tolist()) == first_ten


@pytest.mark.parametrize("kind", ["uniform", "clustered"])
def test_dtable_and_adc_bit_equal(kind):
    cw, codes, _, _, q = _small(kind)
    dt_t, dt_j = TO.dtable_np(q, cw), JO.dtable_np(q, cw)
    np.testing.assert_array_equal(dt_t, dt_j)
    np.testing.assert_array_equal(TO.adc_np(dt_t, codes), JO.adc_np(dt_j, codes))


# ---- the engine against the oracle (tests/test_oracle_parity.py's config) ---

N, D, TOPK = 8000, 32, 10
L_FRACS = (0.02, 0.05, 0.125)


def _clustered(n, d, n_clusters, seed, spread=0.15):
    rng = np.random.RandomState(seed)
    centers = rng.normal(0, 1, (n_clusters, d)).astype(np.float32)
    assign = rng.randint(0, n_clusters, n)
    x = centers[assign] + spread * rng.normal(0, 1, (n, d)).astype(np.float32)
    return np.ascontiguousarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def setup():
    X = _clustered(N, D, 40, seed=3)
    rng = np.random.RandomState(4)
    jpq = rii_tpu.PQ(M=4, Ks=64).fit(X[rng.choice(N, 2000, replace=False)], iter=5)
    je = rii_tpu.Rii(jpq)
    je.add_configure(X, nlist=40, iter=5)
    queries = X[rng.choice(N, 24, replace=False)] \
        + 0.02 * rng.normal(0, 1, (24, D)).astype(np.float32)
    tids = np.sort(rng.choice(N, 1500, replace=False)).astype(np.int64)
    te = port_engine(je)
    assert te.posting_lists == je.posting_lists
    return dict(X=X, jpq=jpq, je=je, te=te, queries=queries, tids=tids,
                oracle={})


def _L(frac, subset, s):
    return max(10, int(frac * (len(s["tids"]) if subset else N)))


def _oracle(s, frac, subset):
    """The oracle's answers for the 24 queries (cached: every engine of the
    module holds the same codes and posting lists)."""
    key = (frac, subset)
    if key not in s["oracle"]:
        te = s["te"]
        tids = s["tids"] if subset else None
        s["oracle"][key] = [
            TO.query_ivf_oracle(q, TOPK, _L(frac, subset, s), te.codewords,
                                te.coarse_centers, te.posting_lists, te.codes,
                                target_ids=tids)[1]
            for q in s["queries"]]
    return s["oracle"][key]


def _dominance(engine_d, oracle_d):
    """Share of the oracle's (query, rank) entries the engine dominates."""
    hits = total = 0
    for row, d_o in zip(engine_d, oracle_d):
        k = len(d_o)
        hits += int((row[:k] <= d_o * (1 + 1e-4) + 1e-6).sum())
        total += k
    return hits / total


def _query(e, s, frac, subset):
    return e.query_batch(s["queries"], topk=TOPK, L=_L(frac, subset, s),
                         target_ids=s["tids"] if subset else None, method="ivf")


@pytest.mark.parametrize("mode", ["default", "exact"])
@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("frac", L_FRACS)
def test_engine_dominates_the_oracle(setup, mode, subset, frac):
    te = setup["te"]
    te.topk_recall = None if mode == "exact" else 0.99
    try:
        ids, dists = _query(te, setup, frac, subset)
    finally:
        te.topk_recall = 0.99
    assert _dominance(dists, _oracle(setup, frac, subset)) == 1.0
    if subset:
        assert np.isin(ids[ids >= 0], setup["tids"]).all()


def test_linear_oracle_adc_identity(setup):
    """The port's linear distances equal the table-lookup ADC oracle: the
    top-k distance multiset matches, and every returned id's oracle
    distance lies within the oracle's k-th."""
    te, queries = setup["te"], setup["queries"]
    for i in range(4):
        ids_o, d_o = TO.query_linear_oracle(queries[i], TOPK, te.codewords, te.codes)
        ids_e, d_e = te.query(queries[i], topk=TOPK, method="linear")
        np.testing.assert_allclose(np.sort(d_e), np.sort(d_o), rtol=1e-4)
        d_e_oracle = TO.adc_np(TO.dtable_np(queries[i], te.codewords), te.codes[ids_e])
        assert (d_e_oracle <= d_o[-1] * (1 + 1e-4) + 1e-6).all()


@pytest.fixture(scope="module")
def kernel_routes(setup):
    """Per scan mode, rii_tpu's engine on Pallas interpret mode and the
    port's on its kernels' twins, over the same arrays."""
    out = {}
    for mode in ("bf16", "pq", "int8"):
        je = rii_tpu.Rii(setup["jpq"])
        je.scan_mode = mode
        je.pallas_interpret = True
        je.add_configure(setup["X"], nlist=40, iter=5)
        assert je.posting_lists == setup["te"].posting_lists
        out[mode] = (je, port_engine(je, scan_mode=mode, force_kernel_routing=True))
    return out


@pytest.mark.parametrize("mode", ["bf16", "pq", "int8"])
@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("frac", L_FRACS)
def test_kernel_route_dominance_equals_rii_tpu(setup, kernel_routes, mode,
                                               subset, frac):
    je, te = kernel_routes[mode]
    oracle_d = _oracle(setup, frac, subset)
    f_j = _dominance(_query(je, setup, frac, subset)[1], oracle_d)
    f_t = _dominance(_query(te, setup, frac, subset)[1], oracle_d)
    assert abs(f_t - f_j) <= 1 / (len(setup["queries"]) * TOPK), (f_t, f_j)


# ---- tests/test_rescore.py's oracle cases, on the port's engine ----------


@pytest.fixture(scope="module")
def rescore_engine():
    rng = np.random.RandomState(5)
    n, d = 6000, 64
    X = rng.random((n, d)).astype(np.float32)
    jpq = rii_tpu.PQ(M=8, Ks=64, verbose=False).fit(X[:2000], iter=3)
    e = Rii(PQ.from_codewords(jpq.codewords, device="cpu"))
    e.scan_mode = "bf16"  # the default-tier path under test
    e.add_configure(X, nlist=40, iter=3)
    q = (X[:12] + 0.01 * rng.normal(0, 1, (12, d))).astype(np.float32)
    return e, q


def _oracle_dists(e, q, ids):
    dt = TO.dtable_np(q, e.codewords)
    codes = e.codes
    return np.array([TO.adc_np(dt, codes[i:i + 1])[0] if i >= 0 else np.inf
                     for i in ids])


@pytest.mark.parametrize("method,kw", [("linear", {}), ("ivf", {"L": 600})])
def test_rescored_distances_are_exact_adc(rescore_engine, method, kw):
    e, q = rescore_engine
    e.exact_rescore = True
    try:
        ids, dists = e.query_batch(q, topk=8, method=method, **kw)
    finally:
        e.exact_rescore = "auto"
    for i in range(len(q)):
        ref = _oracle_dists(e, q[i], ids[i])
        valid = ids[i] >= 0
        np.testing.assert_allclose(dists[i][valid], ref[valid], rtol=2e-5, atol=1e-5)


def test_rescore_off_keeps_bf16_class(rescore_engine):
    e, q = rescore_engine
    e.exact_rescore = False
    try:
        ids, dists = e.query_batch(q, topk=8, method="linear")
    finally:
        e.exact_rescore = "auto"
    for i in range(len(q)):
        ref = _oracle_dists(e, q[i], ids[i])
        valid = ids[i] >= 0
        np.testing.assert_allclose(dists[i][valid], ref[valid], rtol=2e-2, atol=2e-3)


def test_rescore_subset_excludes_and_is_exact(rescore_engine):
    e, q = rescore_engine
    tids = np.sort(np.random.RandomState(7).choice(e.N, 5000, replace=False)).astype(np.int64)
    tset = set(tids.tolist())
    e.exact_rescore = True
    try:
        ids, dists = e.query_batch(q, topk=8, method="linear", target_ids=tids)
    finally:
        e.exact_rescore = "auto"
    for i in range(len(q)):
        valid = ids[i] >= 0
        assert set(ids[i][valid].tolist()) <= tset
        ref = _oracle_dists(e, q[i], ids[i])
        np.testing.assert_allclose(dists[i][valid], ref[valid], rtol=2e-5, atol=1e-5)


def test_rescore_improves_or_matches_recall(rescore_engine):
    e, q = rescore_engine
    gt = [np.argsort(TO.adc_np(TO.dtable_np(q[i], e.codewords), e.codes),
                     kind="stable")[:8] for i in range(len(q))]
    e.exact_rescore = False
    ids_off, _ = e.query_batch(q, topk=8, method="linear")
    e.exact_rescore = True
    try:
        ids_on, _ = e.query_batch(q, topk=8, method="linear")
    finally:
        e.exact_rescore = "auto"

    def overlap(a, b):
        return np.mean([len(set(x.tolist()) & set(y.tolist())) / 8
                        for x, y in zip(a, b)])

    assert overlap(ids_on, gt) >= overlap(ids_off, gt) - 1e-9
