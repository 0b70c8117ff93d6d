"""The union's selections on the CPU: the selection kernel's plain twin
(``ops/select.py``), the union of the batch's probes, the pq union's kernel
branch on tie-heavy codes against rii_tpu in Pallas interpret mode, and the
``select_kernel`` counter of the engine's root span.

The kernel itself is held to the twin on the card
(``test_torch_gpu_select.py``)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

from rii_tpu.ops import ivf as JI
from rii_tpu.ops import pallas_scan as P
from rii_tpu_torch import PQ, Rii
from rii_tpu_torch.models.ivf import build_virtual_layout, code_norms_np
from rii_tpu_torch.ops import ivf as TI
from rii_tpu_torch.ops import select as S
from rii_tpu_torch.utils import profiling as prof

from _torch_parity import assert_ranked_ids_match


def _scores(rows, n, ties, seed):
    rng = np.random.RandomState(seed)
    if ties:
        x = rng.choice([-0.75, 0.5, 2.0, np.inf], (rows, n))
    else:
        x = rng.standard_normal((rows, n))
        x[:, n // 3:n // 2] = np.inf
    return torch.tensor(x, dtype=torch.float32)


@pytest.mark.parametrize("rows,n,k", [(1, 1, 1), (3, 5, 8), (4, 31, 20),
                                      (8, 4097, 64), (2, 1000, 256),
                                      (5, 300, 300)])
@pytest.mark.parametrize("ties", [False, True])
def test_twin_is_the_stable_sort(rows, n, k, ties):
    """min(k, n) columns, equal to the stable sort sliced; the values equal
    torch.topk's, which breaks ties in no stated order."""
    x = _scores(rows, n, ties, n + k)
    before = S.smallest_k.launches
    v, c = S.smallest_k(x, k)
    kk = min(k, n)
    sv, sc = torch.sort(x, dim=1, stable=True)
    assert v.shape == c.shape == (rows, kk) and c.dtype == torch.int64
    assert torch.equal(c, sc[:, :kk]) and torch.equal(v, sv[:, :kk])
    tv, _ = torch.topk(x, kk, dim=1, largest=False, sorted=True)
    assert torch.equal(v, tv)
    assert S.smallest_k.launches == before  # the twin launches nothing
    assert not S.takes_kernel(x, k)


def test_twin_refuses_what_no_selection_takes():
    with pytest.raises(ValueError):
        S.smallest_k(torch.zeros(4, 5, dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        S.smallest_k(torch.zeros(4, 5), 0)
    with pytest.raises(ValueError):
        S.smallest_k(torch.zeros(20), 2)


def _union_before(q_all, centers_dec, centers_norms, w, nlist_pad,
                  recall_target, probe_recall):
    """The union as it was computed before the selection kernel: every
    probe scored and stably sorted, then thrown away where the batch's
    probes could cover every window."""
    qn = q_all.shape[0]
    pr = recall_target if probe_recall == "inherit" else probe_recall
    cscores = TI._coarse_scores(q_all, centers_dec, centers_norms, pr is None)
    probe = torch.sort(cscores, dim=1, stable=True).indices[:, :w]
    if qn * w >= nlist_pad:
        return (torch.arange(nlist_pad, dtype=torch.int32),
                torch.zeros(nlist_pad, dtype=torch.bool))
    flat = torch.sort(probe.reshape(-1).to(torch.int32)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.bool), flat[1:] == flat[:-1]])
    return flat, dup


@pytest.mark.parametrize("qn,w", [(4, 3), (16, 8), (8, 40), (32, 64)])
@pytest.mark.parametrize("recall_target", [None, 0.9])
def test_union_is_unchanged(qn, w, recall_target):
    """Virtual centers repeat (the windows of one list share its center), so
    the coarse scores tie and the tie rule decides the probes; padded
    windows score +inf. (32, 64) covers the 256 windows."""
    rng = np.random.RandomState(qn * w)
    nlist_pad, d = 256, 16
    real = rng.random((60, d)).astype(np.float32)
    centers = real[rng.randint(0, 60, nlist_pad)]
    norms = (centers ** 2).sum(1)
    norms[-30:] = np.inf
    q = torch.tensor(real[rng.randint(0, 60, qn)]
                     + rng.normal(0, 0.05, (qn, d)).astype(np.float32))
    c, nr = torch.tensor(centers), torch.tensor(norms)
    flat, dup, took = TI._union(q, c, nr, w, nlist_pad, recall_target,
                                "inherit")
    f0, d0 = _union_before(q, c, nr, w, nlist_pad, recall_target, "inherit")
    assert flat.dtype == torch.int32 and dup.dtype == torch.bool
    assert torch.equal(flat, f0) and torch.equal(dup, d0)
    assert took is False
    given = TI._union(q, c, nr, w, nlist_pad, recall_target, "inherit",
                      probes=(f0.long(), d0))
    assert torch.equal(given[0], f0) and torch.equal(given[1], d0)
    assert given[2] is False


D, M, KS, CAP_V = 64, 8, 32, 32


@pytest.fixture(scope="module")
def tied_layout():
    """A grouped code layout whose 3000 rows take only six distinct codes,
    so most scores tie exactly and the selection's tie rule decides which
    slots are kept."""
    rng = np.random.RandomState(23)
    n, nlist = 3000, 12
    cw = (rng.random((M, KS, D // M)) * 0.1).astype(np.float32)
    distinct = rng.randint(0, KS, (6, M)).astype(np.uint8)
    codes = distinct[rng.randint(0, 6, n)]
    assign = rng.randint(0, nlist, n).astype(np.int32)
    norms = code_norms_np(cw, codes)
    ul = build_virtual_layout(codes, norms, assign, nlist, cap_v=CAP_V,
                              headroom=0.125)
    centers = cw[np.arange(M)[None, :], rng.randint(0, KS, (nlist, M))].reshape(nlist, D)
    vr = np.clip(ul["vreal"], 0, nlist - 1)
    rows = cw[np.arange(M)[None, :], codes[:128].astype(np.int64)].reshape(128, D)
    q = (rows + rng.normal(0, 0.01, (128, D))).astype(np.float32)
    return dict(cw=cw, q=q, codes_g=ul["codes_grouped"],
                norms_g=ul["norms_grouped"], order_g=ul["order"],
                vlen=ul["vlen"], nlist_v_pad=ul["nlist_v_pad"],
                centers_dec=centers[vr].astype(np.float32),
                centers_norms=np.where(ul["vreal"] >= 0,
                                       (centers[vr] ** 2).sum(1),
                                       np.inf).astype(np.float32))


@pytest.mark.parametrize("qn", [8, 64])  # kernel E's twin, kernel D's
def test_pq_union_kernel_branch_on_ties_matches_pallas(tied_layout, qn):
    """overfetch=1 keeps exactly the topk slots selected from the tile
    minima, as the JAX package does: with ties broken toward the lower
    column on both sides, each query returns the same ids, ranked alike
    but at ties."""
    lo = tied_layout
    q = lo["q"][:qn]
    args = (lo["codes_g"], lo["norms_g"], lo["order_g"], lo["cw"],
            lo["centers_dec"], lo["centers_norms"])
    kw = dict(w=4, topk=10, cap_u=CAP_V, nlist_pad=lo["nlist_v_pad"],
              recall_target=None)
    dj, ij = JI.ivf_union_scan_topk_pq(
        jnp.asarray(q), *map(jnp.asarray, args), **kw,
        vlen=jnp.asarray(lo["vlen"]),
        cw_padded=P.build_padded_codewords(lo["cw"]), use_pallas=True,
        interpret=True)
    dt, it = TI.ivf_union_scan_topk_pq(
        torch.from_numpy(q), *(torch.tensor(np.asarray(a)) for a in args),
        **kw, vlen=torch.tensor(lo["vlen"]), use_kernel=True, overfetch=1)
    dt, it, dj, ij = dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij)
    assert_ranked_ids_match(it, dt, ij, dj, rtol=1e-5)
    for a, b in zip(it, ij):
        assert sorted(a.tolist()) == sorted(b.tolist())
    # the ties are real: some query's ten answers share a distance
    assert any(len(np.unique(r)) < len(r) for r in dt)


@pytest.fixture(scope="module")
def kernel_route_engine():
    """A CPU engine on the pq tier's kernel routes (kernels D and E through
    their twins), N=40000 over 200 lists: windows of 256 slots, few enough
    of them probed for a one-query batch to stay off the linear scan."""
    X = np.random.RandomState(0).random((40000, 32)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=16, device="cpu").fit(X[:500], iter=2))
    e.scan_mode = "pq"
    e.force_kernel_routing = True
    e.add_configure(X, nlist=200, iter=2)
    e.query_batch(X[:1], topk=3)  # the cache
    assert e._ensure_cache()["pq_kernel_route"]
    return e, X


def _root_of(fn):
    before = {s.id for s in prof.spans()}
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    roots = [s for s in prof.spans()
             if s.id not in before and s.parent is None]
    assert len(roots) == 1
    return roots[0]


@pytest.mark.parametrize("on_card", [False, True])
def test_select_kernel_counts_the_unions_selections(kernel_route_engine,
                                                    monkeypatch, on_card):
    """The root's ``select_kernel``: the union's selections (probe, tile
    minima) that took the kernel. The CPU takes the twin, 0; with
    ``takes_kernel`` answering as it would on the card, 2."""
    e, X = kernel_route_engine
    if on_card:
        monkeypatch.setattr(TI, "takes_kernel", lambda scores, k: True)
    q = X[np.asarray(e.posting_lists[5][:1])]
    root = _root_of(lambda: e.query_batch(q, topk=10, method="ivf", L=e.L0))
    assert root.attrs["route"] == "ivf"
    assert root.attrs["select_kernel"] == (2 if on_card else 0)
    # the linear route runs no union and sets no counter
    root = _root_of(lambda: e.query_batch(q, topk=10, method="linear"))
    assert "select_kernel" not in root.attrs


def test_select_kernel_on_the_plain_branch(kernel_route_engine, monkeypatch):
    """The plain chunked branch selects its tiles with torch.topk: only the
    probe selection can count."""
    e, X = kernel_route_engine
    monkeypatch.setattr(TI, "takes_kernel", lambda scores, k: True)
    q = X[np.asarray(e.posting_lists[5][:1])]
    e.force_kernel_routing = False
    try:
        root = _root_of(lambda: e.query_batch(q, topk=10, method="ivf",
                                              L=e.L0))
    finally:
        e.force_kernel_routing = True
    assert root.attrs["route"] == "ivf"
    assert root.attrs["select_kernel"] == 1
