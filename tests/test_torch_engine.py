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
# the int8 tier always rescores in exact float32 ADC; the two packages sum
# the rescore in other orders, and ||x||^2 + ||q||^2 (~40 here) cancel to
# distances of ~3, so the float32 steps show at ~1e-5
RESCORE_RTOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(9)
    X = rng.random((N, D)).astype(np.float32)
    jpq = rii_tpu.PQ(M=8, Ks=32).fit(X[:1024], iter=3)
    engines = {}
    for mode in ("exact", "fast"):
        je = rii_tpu.Rii(jpq)
        te = Rii(PQ.from_codewords(jpq.codewords, device="cpu"))
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
                            je._assignments(), device="cpu")
    ce.topk_recall = None
    assert ce.posting_lists == je.posting_lists
    for method in ("linear", "ivf"):
        ij, dj = je.query_batch(setup["Q"], topk=10, method=method)
        ic, dc = ce.query_batch(setup["Q"], topk=10, method=method)
        assert_ranked_ids_match(ic, dc, ij, dj, rtol=EXACT_RTOL)


def test_add_after_configure_rebuilds_cache(setup):
    """add() drops the cache; the rebuilt one answers as a fresh engine."""
    X = setup["X"]
    te = Rii(PQ.from_codewords(setup["jpq"].codewords, device="cpu"))
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


@pytest.mark.parametrize("scan_mode,kernel", [("int8", "K4")])
def test_unported_tiers_raise(setup, scan_mode, kernel):
    """The tier that raised before its kernels were ported (K4 for the int8
    replica) now answers as the JAX engine does: the port through kernel
    F's twin, rii_tpu through Pallas interpret mode, both rescoring
    exactly."""
    je = rii_tpu.Rii(setup["jpq"])
    te = Rii(PQ.from_codewords(setup["jpq"].codewords, device="cpu"))
    je.scan_mode = te.scan_mode = scan_mode
    je.pallas_interpret = True
    te.force_kernel_routing = True
    je.add_configure(setup["X"], nlist=NLIST, iter=3)
    te.add_configure(setup["X"], nlist=NLIST, iter=3)
    assert "decoded_i8" in te._ensure_cache()
    ij, dj = je.query_batch(setup["Q"], topk=5, method="linear")
    it, dt = te.query_batch(setup["Q"], topk=5, method="linear")
    assert_ranked_ids_match(it, dt, ij, dj, rtol=RESCORE_RTOL)


def test_ivf_falls_back_to_linear_before_the_window_tier_matters(setup):
    """A bf16 replica with int8 windows: an IVF batch whose probe union
    covers half the capacity goes to the linear scan, as in the JAX engine,
    before the window tier is read."""
    budget = 8192 * 160 + 16384 * 64  # the replica fits, bf16 windows do not
    X = setup["X"]
    je = rii_tpu.Rii(setup["jpq"])
    te = Rii(PQ.from_codewords(setup["jpq"].codewords, device="cpu"))
    je.scan_mode = te.scan_mode = "bf16"
    je.decoded_cache_budget = te.decoded_cache_budget = budget
    je.pallas_interpret = True
    te.force_kernel_routing = True
    je.add_configure(X, nlist=NLIST, iter=3)
    te.add_configure(X, nlist=NLIST, iter=3)
    dc = te._ensure_cache()
    assert "decoded_t" in dc and dc["windows"] == "int8"
    ij, dj = je.query_batch(X[:256], topk=10, method="ivf")
    it, dt = te.query_batch(X[:256], topk=10, method="ivf")
    np.testing.assert_allclose(dt, dj, rtol=FAST_RTOL, atol=FAST_RTOL)
    assert (it[:, 0] == ij[:, 0]).all()


# the pq tier at a size where an IVF batch stays off the linear scan:
# 2 * union rows (Q*wv windows of 256) < cap = 32768
PQ_N, PQ_NLIST = 20000, 200


@pytest.fixture(scope="module")
def pq_setup(setup):
    rng = np.random.RandomState(19)
    X = rng.random((PQ_N, D)).astype(np.float32)
    je = rii_tpu.Rii(setup["jpq"])
    te = Rii(PQ.from_codewords(setup["jpq"].codewords, device="cpu"))
    je.scan_mode = te.scan_mode = "pq"
    je.pallas_interpret = True
    te.force_kernel_routing = True
    je.add_configure(X, nlist=PQ_NLIST, iter=3)
    te.add_configure(X, nlist=PQ_NLIST, iter=3)
    Q = (X[:16] + rng.normal(0, 0.01, (16, D))).astype(np.float32)
    return dict(X=X, je=je, te=te, Q=Q, rng=rng)


def test_int8_windows_raise_where_ivf_reads_them(setup, pq_setup, monkeypatch):
    """A bf16 replica with int8 windows, where the port raised before K6 was
    ported: a batch that stays off the linear scan now reads the windows
    through kernel G's twin and answers as the JAX engine does."""
    import rii_tpu_torch.ops.ivf as TI
    budget = 32768 * 160 + 51200 * 64
    je = rii_tpu.Rii(setup["jpq"])
    te = Rii(PQ.from_codewords(setup["jpq"].codewords, device="cpu"))
    je.scan_mode = te.scan_mode = "bf16"
    je.decoded_cache_budget = te.decoded_cache_budget = budget
    je.pallas_interpret = True
    te.force_kernel_routing = True
    je.add_configure(pq_setup["X"], nlist=PQ_NLIST, iter=3)
    te.add_configure(pq_setup["X"], nlist=PQ_NLIST, iter=3)
    dc = te._ensure_cache()
    assert "decoded_t" in dc and dc["windows"] == "int8"
    assert "decoded_g_i8" in je._ensure_cache()
    calls = []
    real = TI.ivf_i8_window_tile_minima
    monkeypatch.setattr(TI, "ivf_i8_window_tile_minima",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q = pq_setup["Q"][:8]
    ij, dj = je.query_batch(q, topk=5, L=50, method="ivf")
    it, dt = te.query_batch(q, topk=5, L=50, method="ivf")
    assert calls == [1]  # the batch stayed off the linear scan
    assert_ranked_ids_match(it, dt, ij, dj, rtol=RESCORE_RTOL)


@pytest.mark.parametrize("method,subset,qn,L", [
    ("linear", None, 16, None), ("ivf", None, 8, 50),
    ("linear", 5000, 16, None), ("ivf", 5000, 8, 10)])
def test_pq_tier_kernel_routes_match(pq_setup, monkeypatch, method, subset,
                                     qn, L):
    """The pq tier on the kernel routes (the port through kernels C and E's
    twins, the JAX engine through Pallas interpret mode) against JAX: the
    linear scan selects only (bf16-class distances), IVF rescores."""
    import rii_tpu_torch.ops.ivf as TI
    je, te = pq_setup["je"], pq_setup["te"]
    dc = te._ensure_cache()
    assert dc["mode"] == "pq" and "codes_t" in dc and dc["windows"] == "pq"
    calls = []
    real = TI.ivf_dt_window_tile_minima
    monkeypatch.setattr(TI, "ivf_dt_window_tile_minima",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tids = None
    if subset is not None:
        tids = np.sort(pq_setup["rng"].choice(PQ_N, subset, replace=False)).astype(np.int64)
    q = pq_setup["Q"][:qn]
    ij, dj = je.query_batch(q, topk=5, L=L, method=method, target_ids=tids)
    it, dt = te.query_batch(q, topk=5, L=L, method=method, target_ids=tids)
    assert bool(calls) == (method == "ivf")  # IVF stayed off the linear scan
    np.testing.assert_allclose(dt, dj, rtol=FAST_RTOL, atol=FAST_RTOL)
    assert (it[:, 0] == ij[:, 0]).all()
    if tids is not None:
        assert np.isin(it, tids).all()


@pytest.fixture(scope="module")
def i8_setup(setup, pq_setup):
    """The int8 tier on its kernel routes (default budget: the int8 replica
    and int8 windows) over pq_setup's data, in both packages."""
    je = rii_tpu.Rii(setup["jpq"])
    te = Rii(PQ.from_codewords(setup["jpq"].codewords, device="cpu"))
    je.scan_mode = te.scan_mode = "int8"
    je.pallas_interpret = True
    te.force_kernel_routing = True
    je.add_configure(pq_setup["X"], nlist=PQ_NLIST, iter=3)
    te.add_configure(pq_setup["X"], nlist=PQ_NLIST, iter=3)
    return dict(pq_setup, je=je, te=te)


@pytest.mark.parametrize("method,subset,qn,L", [
    ("linear", None, 16, None), ("ivf", None, 8, 50),
    ("linear", 1000, 16, None), ("linear", 5000, 16, None),
    ("ivf", 5000, 8, 10)])
def test_int8_tier_kernel_routes_match(i8_setup, monkeypatch, method, subset,
                                       qn, L):
    """The int8 tier (the port through kernels F and G's twins, the JAX
    engine through Pallas interpret mode): linear full scans and subsets
    above 4096 take the int8 replica, subsets of 4096 or fewer the exact
    subset scan over the codes, IVF the int8 windows; every route returns
    exact-ADC distances."""
    import rii_tpu_torch.ops.hopper_i8 as HI
    import rii_tpu_torch.ops.ivf as TI
    import rii_tpu_torch.rii as TR
    je, te = i8_setup["je"], i8_setup["te"]
    dc = te._ensure_cache()
    assert dc["mode"] == "int8" and "decoded_i8" in dc
    assert dc["windows"] == "int8" and "codes_g" not in dc
    calls = []
    for mod, name in ((TI, "ivf_i8_window_tile_minima"),
                      (TR, "replica_i8_scan_topk_t")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    before = HI.replica_i8_tile_keys.launches
    tids = None
    if subset is not None:
        tids = np.sort(i8_setup["rng"].choice(PQ_N, subset, replace=False)).astype(np.int64)
    q = i8_setup["Q"][:qn]
    ij, dj = je.query_batch(q, topk=5, L=L, method=method, target_ids=tids)
    it, dt = te.query_batch(q, topk=5, L=L, method=method, target_ids=tids)
    want = {"ivf": ["ivf_i8_window_tile_minima"],
            "linear": [] if subset == 1000 else ["replica_i8_scan_topk_t"]}
    assert calls == want[method]
    assert HI.replica_i8_tile_keys.launches == before  # CPU: the twin
    assert_ranked_ids_match(it, dt, ij, dj, rtol=RESCORE_RTOL)
    if tids is not None:
        assert np.isin(it, tids).all()


def test_int8_windows_hold_what_jax_holds(i8_setup):
    """The int8 replica and windows equal the JAX engine's bit for bit (the
    port's replica row-major, the transpose of JAX's decoded_i8_t); the
    windows keep their own scales and member counts, and no grouped codes
    (the rescore reads codes_flat through order_g)."""
    jdc, dc = i8_setup["je"]._ensure_cache(), i8_setup["te"]._ensure_cache()
    assert "codes_g" not in jdc and "codes_g" not in dc
    for key in ("i8_scales", "i8_scales_g", "decoded_g_i8", "vlen_g",
                "order_g"):
        np.testing.assert_array_equal(dc[key].numpy(), np.asarray(jdc[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(dc["decoded_i8"].numpy(),
                                  np.asarray(jdc["decoded_i8_t"]).T)


def test_int8_window_budget_counts_the_int8_replica(setup):
    """The window gate counts an int8 replica as cap*(D+32) bytes, as the
    JAX engine does: with cap*D <= budget < cap*(D+32) + total*D the
    windows are uint8 codes in both packages (not counting the replica, the
    port chose int8 windows beyond the budget)."""
    budget = 800_000  # cap*D = 524288, cap*(D+32) = 786432 at cap 8192
    je = rii_tpu.Rii(setup["jpq"])
    te = Rii(PQ.from_codewords(setup["jpq"].codewords, device="cpu"))
    je.scan_mode = te.scan_mode = "int8"
    je.decoded_cache_budget = te.decoded_cache_budget = budget
    je.pallas_interpret = True
    te.force_kernel_routing = True
    je.add_configure(setup["X"], nlist=NLIST, iter=3)
    te.add_configure(setup["X"], nlist=NLIST, iter=3)
    jdc, dc = je._ensure_cache(), te._ensure_cache()
    total = dc["nlist_v_pad"] * dc["cap_v"]
    assert dc["cap"] * D <= budget < dc["cap"] * (D + 32) + total * D
    assert total * D <= budget  # what the old gate would have admitted
    assert dc["mode"] == "int8" and "decoded_i8_t" in jdc
    assert dc["windows"] == ("int8" if "decoded_g_i8" in jdc else "pq") == "pq"
    mem = te.memory_breakdown()
    assert mem["device:decoded_i8"] == dc["cap"] * D <= budget


@pytest.mark.parametrize("band,scan_mode,budget,replica,windows", [
    ("int8 replica, pq windows", "int8", 800_000, "decoded_i8_t", "codes_g"),
    ("bf16 replica, int8 windows", "bf16", 32768 * 160 + 51200 * 64,
     "decoded_t", "decoded_g_i8"),
    ("int8 replica, int8 windows", "int8", 2 << 30, "decoded_i8_t",
     "decoded_g_i8")])
def test_memory_breakdown_within_budget_at_int8_bands(setup, pq_setup, band,
                                                      scan_mode, budget,
                                                      replica, windows):
    """memory_breakdown reports the device bytes of each cache entry as the
    JAX engine's does; at each band the replica and the decoded windows
    stay within decoded_cache_budget (the gate's intent). ``replica`` is
    the JAX engine's key; the port keeps its int8 replica row-major, as
    ``decoded_i8``, in the same bytes."""
    X = setup["X"] if budget == 800_000 else pq_setup["X"]
    nlist = NLIST if budget == 800_000 else PQ_NLIST
    je = rii_tpu.Rii(setup["jpq"])
    te = Rii(PQ.from_codewords(setup["jpq"].codewords, device="cpu"))
    je.scan_mode = te.scan_mode = scan_mode
    je.decoded_cache_budget = te.decoded_cache_budget = budget
    je.pallas_interpret = True
    te.force_kernel_routing = True
    je.add_configure(X, nlist=nlist, iter=3)
    te.add_configure(X, nlist=nlist, iter=3)
    mj, mt = je.memory_breakdown(), te.memory_breakdown()
    assert mt["host_codes"] == mj["host_codes"]
    port_replica = {"decoded_i8_t": "decoded_i8"}.get(replica, replica)
    assert mt[f"device:{port_replica}"] == mj[f"device:{replica}"]
    for key in (windows, "codes_flat", "norms_flat", "order_g", "norms_g"):
        assert mt[f"device:{key}"] == mj[f"device:{key}"], key
    held = mt[f"device:{port_replica}"]
    if windows != "codes_g":
        held += mt[f"device:{windows}"]
    assert held <= budget, band
    tensors = [v for v in te._dc.values() if isinstance(v, torch.Tensor)]
    assert mt["device_total"] <= sum(v.numel() * v.element_size() for v in tensors)
    assert mt["device_total"] >= held


def test_cuda_without_a_card_raises(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Rii(PQ.from_codewords(setup["jpq"].codewords, device="cpu"), device="cuda")


def test_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; import rii_tpu_torch; "
            "import rii_tpu_torch.utils.convert, rii_tpu_torch.ops.ivf; "
            "import rii_tpu_torch.parallel; "
            "assert 'rii_tpu' not in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("ds", [64, 65])
def test_wide_rows_stay_on_kernels_a_and_h(ds):
    """Kernels A and H take any D: on the kernel routes a bf16 replica of
    rows wider than 512 (D = 8 * 65 = 520) is chosen as at D = 512, in both
    modes, as rii_tpu chooses it (the replica fits the budget)."""
    cw = np.random.RandomState(0).random((8, 16, ds)).astype(np.float32)
    e = Rii(PQ.from_codewords(cw, device="cpu"))
    e.scan_mode = "bf16"
    e.force_kernel_routing = True
    assert e._resolve_scan_mode(1024) == "bf16"
    e.topk_recall = None
    assert e._resolve_scan_mode(1024) == "bf16"


def test_wide_rowmajor_cache_takes_kernel_h(monkeypatch):
    """A cache built in exact mode over rows wider than 512 (D = 8 * 65 =
    520) is scanned by kernel H (its twin here) once topk_recall is set
    again, and answers as rii_tpu's K11 route (Pallas interpret mode) on the
    same arrays: one candidate a 128-slot tile, rescored in exact ADC."""
    import jax.numpy as jnp
    from rii_tpu.ops import pallas_scan as P
    from rii_tpu_torch import rii as port_rii

    rng = np.random.RandomState(4)
    cw = rng.random((8, 16, 65)).astype(np.float32)
    codes = rng.randint(0, 16, (600, 8)).astype(np.uint8)
    # queries away from the rows: distances of tens, so the float32 sums
    # of a few hundred do not cancel below the tolerance
    q = rng.random((5, 520)).astype(np.float32)
    e = Rii(PQ.from_codewords(cw, device="cpu"))
    e.scan_mode = "bf16"
    e.force_kernel_routing = True
    e.topk_recall = None
    e.add_codes(codes)
    e.reconfigure(nlist=4, iter=2)
    e.query_batch(q, topk=5, method="linear")
    dc = e._ensure_cache()
    assert "decoded_flat" in dc
    calls = []
    real = port_rii.replica_scan_topk
    monkeypatch.setattr(port_rii, "replica_scan_topk",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    e.topk_recall = 0.99
    ids, dists = e.query_batch(q, topk=5, method="linear")
    assert calls == [1]
    d_j, i_j = P.replica_scan_topk(
        jnp.asarray(q), jnp.asarray(dc["decoded_flat"].float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(dc["norms_flat"].numpy()[:, None]), topk=5,
        blk=min(8192, dc["cap"]), interpret=True, recall_target=None,
        packed=True, codes=jnp.asarray(dc["codes_flat"].numpy()),
        codewords=jnp.asarray(dc["codewords"].float().numpy()))
    assert_ranked_ids_match(ids, dists, np.asarray(i_j), np.asarray(d_j),
                            rtol=RESCORE_RTOL)
