"""The slice end to end: rii_tpu_torch.Rii against rii_tpu.Rii.

N=6000, D=64, M=8, Ks=32, nlist=40. Both engines share the JAX codec's
codewords and run add_configure on the same X. Exact mode
(``topk_recall=None``) must give the same ids per rank (ties aside) and
distances within 3e-6 relative; the fast mode on the kernel routes (the
JAX engine through Pallas interpret mode, the port through its kernels'
plain twins) gives distances in the bf16 class (3e-2)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rii_tpu
from rii_tpu_torch import PQ, Rii
from rii_tpu_torch.utils.convert import engine_from_arrays

from _torch_parity import (assert_assignments_equal_but_near_ties,
                           assert_ranked_ids_match)

N, D, NLIST = 6000, 64, 40
EXACT_RTOL = 3e-6
FAST_RTOL = 3e-2


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(9)
    X = rng.random((N, D)).astype(np.float32)
    jpq = rii_tpu.PQ(M=8, Ks=32).fit(X[:1024], iter=3)
    engines = {}
    for mode in ("exact", "fast"):
        je = rii_tpu.Rii(jpq)
        te = Rii(PQ.from_codewords(jpq.codewords))
        if mode == "exact":
            je.topk_recall = te.topk_recall = None
        else:
            je.scan_mode = te.scan_mode = "bf16"
            je.pallas_interpret = True
            te.force_kernel_routing = True
        je.add_configure(X, nlist=NLIST, iter=3)
        te.add_configure(X, nlist=NLIST, iter=3)
        engines[mode] = (je, te)
    Q = (X[:16] + rng.normal(0, 0.01, (16, D))).astype(np.float32)
    return dict(X=X, jpq=jpq, engines=engines, Q=Q, rng=rng)


def test_posting_lists_equal(setup):
    je, te = setup["engines"]["exact"]
    np.testing.assert_array_equal(te.coarse_centers, je.coarse_centers)
    np.testing.assert_array_equal(te.codes, je.codes)
    a_j, a_t = je._assignments(), te._assignments()
    assert_assignments_equal_but_near_ties(je.codewords, je.codes,
                                           je.coarse_centers, a_j, a_t)
    if (a_j == a_t).all():
        assert te.posting_lists == je.posting_lists
    assert sorted(i for pl in te.posting_lists for i in pl) == list(range(N))
    assert all(pl == sorted(pl) for pl in te.posting_lists)


def _subset(setup, size):
    return np.sort(setup["rng"].choice(N, size, replace=False)).astype(np.int64)


@pytest.mark.parametrize("method", ["linear", "ivf"])
@pytest.mark.parametrize("subset", [None, 1000, 5000])
def test_exact_mode_matches(setup, method, subset):
    je, te = setup["engines"]["exact"]
    tids = None if subset is None else _subset(setup, subset)
    ij, dj = je.query_batch(setup["Q"], topk=10, method=method, target_ids=tids)
    it, dt = te.query_batch(setup["Q"], topk=10, method=method, target_ids=tids)
    assert it.dtype == np.int64 and dt.dtype == np.float64
    assert_ranked_ids_match(it, dt, ij, dj, rtol=EXACT_RTOL)
    if tids is not None:
        assert np.isin(it, tids).all()


@pytest.mark.parametrize("method", ["linear", "ivf"])
@pytest.mark.parametrize("subset", [None, 1000, 5000])
def test_fast_mode_kernel_routes_match(setup, method, subset):
    je, te = setup["engines"]["fast"]
    dc = te._ensure_cache()
    assert "decoded_t" in dc and dc["windows"] == "bf16"
    tids = None if subset is None else _subset(setup, subset)
    ij, dj = je.query_batch(setup["Q"], topk=10, method=method, target_ids=tids)
    it, dt = te.query_batch(setup["Q"], topk=10, method=method, target_ids=tids)
    np.testing.assert_allclose(dt, dj, rtol=FAST_RTOL, atol=FAST_RTOL)
    assert (it[:, 0] == ij[:, 0]).all()
    if tids is not None:
        assert np.isin(it, tids).all()


def test_auto_method_and_single_query(setup):
    je, te = setup["engines"]["exact"]
    q = setup["Q"][0]
    ids_j, d_j = je.query(q, topk=5)
    ids_t, d_t = te.query(q, topk=5)
    assert ids_t.shape == (5,) and ids_t.dtype == np.int64
    assert_ranked_ids_match(ids_t[None], d_t[None], ids_j[None], d_j[None],
                            rtol=EXACT_RTOL)
    i1, d1 = te.query_linear(q, topk=5)
    i2, d2 = te.query_ivf(q, topk=5, target_ids=None, L=N)
    np.testing.assert_array_equal(i1, i2)


def test_dtype_contract(setup):
    _, te = setup["engines"]["exact"]
    with pytest.raises(TypeError):
        te.query_batch(setup["Q"].astype(np.float64), topk=3)
    with pytest.raises(TypeError):
        te.query(setup["Q"][0], topk=3, target_ids=np.arange(10, dtype=np.int32))
    with pytest.raises(TypeError):
        te.add_codes(np.zeros((3, 8), dtype=np.int32))


def test_results_padded_with_minus_one_and_inf(setup):
    je, te = setup["engines"]["exact"]
    q = setup["Q"][0]
    tids = np.array([3, 17, 42], dtype=np.int64)
    ij, dj = je.query_linear(q, topk=5, target_ids=tids)
    it, dt = te.query_linear(q, topk=5, target_ids=tids)
    np.testing.assert_array_equal(it, ij)
    assert (it[3:] == -1).all() and np.isinf(dt[3:]).all()
    assert set(it[:3].tolist()) == set(tids.tolist())


def test_ivf_widens_when_probes_find_too_few(setup):
    """A subset whose members the probes miss: IVF widens to a full scan
    and still returns topk valid ids (the reference keeps walking lists)."""
    je, te = setup["engines"]["exact"]
    tids = np.arange(20, dtype=np.int64)
    ij, dj = je.query_batch(setup["Q"][8:12], topk=10, L=50, target_ids=tids,
                            method="ivf")
    it, dt = te.query_batch(setup["Q"][8:12], topk=10, L=50, target_ids=tids,
                            method="ivf")
    assert (it >= 0).all() and np.isfinite(dt).all()
    assert_ranked_ids_match(it, dt, ij, dj, rtol=EXACT_RTOL)


def test_engine_from_arrays_gives_jax_answers(setup):
    je, _ = setup["engines"]["exact"]
    ce = engine_from_arrays(je.codewords, je.codes, je.coarse_centers,
                            je._assignments())
    ce.topk_recall = None
    assert ce.posting_lists == je.posting_lists
    for method in ("linear", "ivf"):
        ij, dj = je.query_batch(setup["Q"], topk=10, method=method)
        ic, dc = ce.query_batch(setup["Q"], topk=10, method=method)
        assert_ranked_ids_match(ic, dc, ij, dj, rtol=EXACT_RTOL)


def test_add_after_configure_rebuilds_cache(setup):
    """add() drops the cache; the rebuilt one answers as a fresh engine."""
    X = setup["X"]
    te = Rii(PQ.from_codewords(setup["jpq"].codewords))
    te.topk_recall = None
    te.add_configure(X[:4000], nlist=NLIST, iter=3)
    te.query_batch(setup["Q"], topk=5)
    te.add(X[4000:])
    assert te.N == N and te._dc is None
    je = rii_tpu.Rii(setup["jpq"])
    je.topk_recall = None
    je.add_configure(X[:4000], nlist=NLIST, iter=3)
    je.add(X[4000:])
    for method in ("linear", "ivf"):
        ij, dj = je.query_batch(setup["Q"], topk=10, method=method)
        it, dt = te.query_batch(setup["Q"], topk=10, method=method)
        assert_ranked_ids_match(it, dt, ij, dj, rtol=EXACT_RTOL)


@pytest.mark.parametrize("scan_mode,kernel", [("int8", "K4"), ("pq", "K7")])
def test_unported_tiers_raise(setup, scan_mode, kernel):
    te = Rii(PQ.from_codewords(setup["jpq"].codewords))
    te.scan_mode = scan_mode
    te.force_kernel_routing = True
    te.add_configure(setup["X"], nlist=NLIST, iter=3)
    with pytest.raises(NotImplementedError, match=kernel):
        te.query_batch(setup["Q"], topk=5, method="linear")


def test_cuda_without_a_card_raises(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Rii(PQ.from_codewords(setup["jpq"].codewords), device="cuda")


def test_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; import rii_tpu_torch; "
            "import rii_tpu_torch.utils.convert, rii_tpu_torch.ops.ivf; "
            "assert 'rii_tpu' not in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
