"""Kernels D and E's module (the pq tier's IVF window scan) and the pq
union IVF op of rii_tpu_torch against rii_tpu in Pallas interpret mode.

On the CPU the port runs the kernels' plain twins. Codewords are scaled so
that real scores stay below 2 in magnitude, where one packed-key step lies
inside the stated 1e-5 + 1e-5*|s| tolerance (see test_torch_replica_scan).
Kernel E sums the same bf16 table in the same order as the Pallas kernel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rii_tpu.ops import ivf as JI
from rii_tpu.ops import pallas_scan as P
from rii_tpu_torch.models.ivf import build_virtual_layout, code_norms_np
from rii_tpu_torch.ops import hopper_pq as HP
from rii_tpu_torch.ops import ivf as TI
from rii_tpu_torch.ops.select import smallest_k_plain

from _torch_parity import assert_keys_match, assert_ranked_ids_match

D, M, KS, CAP_V = 64, 8, 32, 32


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def layout():
    """A grouped code layout built by the shared virtual-layout code (so
    windows end in padding: vlen < cap_v), its virtual centers, a subset
    mask in grouped order and a sorted union with duplicates."""
    rng = np.random.RandomState(17)
    n, nlist = 3000, 12
    cw = (rng.random((M, KS, D // M)) * 0.1).astype(np.float32)
    codes = rng.randint(0, KS, (n, M)).astype(np.uint8)
    assign = rng.randint(0, nlist, n).astype(np.int32)
    norms = code_norms_np(cw, codes)
    ul = build_virtual_layout(codes, norms, assign, nlist, cap_v=CAP_V,
                              headroom=0.125)
    assert (ul["vlen"][:ul["nlist_v"]] < CAP_V).any()
    order = ul["order"]
    centers = cw[np.arange(M)[None, :], rng.randint(0, KS, (nlist, M))].reshape(nlist, D)
    vr = np.clip(ul["vreal"], 0, nlist - 1)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, 1200, replace=False)] = True
    nwin = ul["nlist_v_pad"]
    flat = np.sort(rng.randint(0, nwin, 40)).astype(np.int32)
    dup = np.concatenate([[0], flat[1:] == flat[:-1]]).astype(np.int32)
    assert dup.sum() > 0
    rows = cw[np.arange(M)[None, :], codes[:128].astype(np.int64)].reshape(128, D)
    q = (rows + rng.normal(0, 0.01, (128, D))).astype(np.float32)
    return dict(
        cw=cw, codes=codes, mask=mask, q=q, flat=flat, dup=dup,
        codes_g=ul["codes_grouped"], norms_g=ul["norms_grouped"],
        order_g=order, vlen=ul["vlen"], nlist_v_pad=nwin,
        centers_dec=centers[vr].astype(np.float32),
        centers_norms=np.where(ul["vreal"] >= 0, (centers[vr] ** 2).sum(1),
                               np.inf).astype(np.float32),
        pen=np.where(mask[np.clip(order, 0, n - 1)] & (order >= 0), 0.0,
                     np.inf).astype(np.float32),
        tm=mask[np.clip(order, 0, n - 1)])


_KERNELS = {
    "K8": (P.ivf_pq_window_tile_minima, HP.ivf_pq_window_tile_minima, 72),
    "K9": (P.ivf_dt_window_tile_minima, HP.ivf_dt_window_tile_minima, 8),
}


@pytest.mark.parametrize("kernel", ["K8", "K9"])
@pytest.mark.parametrize("with_pen", [False, True])
def test_window_top2_matches_pallas(layout, kernel, with_pen):
    lo = layout
    jfn, tfn, qn = _KERNELS[kernel]
    q = lo["q"][:qn]
    pen = lo["pen"] if with_pen else None
    vl = lo["vlen"][lo["flat"]]
    jcw = (jnp.asarray(P.build_padded_codewords(lo["cw"])) if kernel == "K8"
           else jnp.asarray(lo["cw"]))
    vj, aj = jfn(jnp.asarray(q), jnp.asarray(lo["codes_g"]), jcw,
                 jnp.asarray(lo["flat"]), jnp.asarray(lo["dup"]),
                 jnp.asarray(vl), cap_v=CAP_V, interpret=True,
                 pen=None if pen is None else jnp.asarray(pen)[:, None])
    vt, at = tfn(torch.from_numpy(q), _t(lo["codes_g"]), _t(lo["cw"]),
                 _t(lo["flat"]), _t(lo["dup"]), _t(vl), CAP_V,
                 pen=None if pen is None else _t(pen))
    vj, aj, vt, at = map(np.asarray, (vj, aj, vt, at))
    assert vt.shape == (qn, len(lo["flat"]) * 2 * CAP_V // 8) and at.dtype == np.int32
    fin = np.isfinite(vt)
    if kernel == "K8":  # kernel E's scores carry ||q||^2
        assert np.abs(vt[fin]).max() < 2.0
    assert_keys_match(vt, at, vj, aj)
    # duplicate entries: nothing scored, +inf and slot 0
    cols = np.repeat(lo["dup"] != 0, 2 * CAP_V // 8)
    assert np.isinf(vt[:, cols]).all() and (at[:, cols] == 0).all()
    # rows past the member count never come back
    win = at[fin] // CAP_V
    assert ((at[fin] % CAP_V) < lo["vlen"][win]).all()


@pytest.mark.parametrize("qn", [1, 8, 63, 64, 65, 127])
def test_dt_window_twin_matches_pallas_over_q(layout, qn):
    """Kernel E's twin (what the kernel is held to on the card) against
    the Pallas kernel from one query to past two chunks of 64, with the pen
    stream on every other Q."""
    lo = layout
    q = lo["q"][:qn]
    pen = lo["pen"] if qn % 2 else None
    vl = lo["vlen"][lo["flat"]]
    vj, aj = P.ivf_dt_window_tile_minima(
        jnp.asarray(q), jnp.asarray(lo["codes_g"]), jnp.asarray(lo["cw"]),
        jnp.asarray(lo["flat"]), jnp.asarray(lo["dup"]), jnp.asarray(vl),
        cap_v=CAP_V, interpret=True,
        pen=None if pen is None else jnp.asarray(pen)[:, None])
    vt, at = HP.ivf_dt_window_tile_minima(
        torch.from_numpy(q), _t(lo["codes_g"]), _t(lo["cw"]), _t(lo["flat"]),
        _t(lo["dup"]), _t(vl), CAP_V, pen=None if pen is None else _t(pen))
    assert vt.shape == (qn, len(lo["flat"]) * 2 * CAP_V // 8)
    assert_keys_match(*map(np.asarray, (vt, at, vj, aj)))


def test_dtable_kernel_twin_is_bit_equal(layout):
    """Kernel E's twin sums the bf16 table in the Pallas kernel's order."""
    lo = layout
    vl = lo["vlen"][lo["flat"]]
    vj, _ = P.ivf_dt_window_tile_minima(
        jnp.asarray(lo["q"][:16]), jnp.asarray(lo["codes_g"]),
        jnp.asarray(lo["cw"]), jnp.asarray(lo["flat"]), jnp.asarray(lo["dup"]),
        jnp.asarray(vl), cap_v=CAP_V, interpret=True)
    vt, _ = HP.ivf_dt_window_tile_minima(
        torch.from_numpy(lo["q"][:16]), _t(lo["codes_g"]), _t(lo["cw"]),
        _t(lo["flat"]), _t(lo["dup"]), _t(vl), CAP_V)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def _window_args(lo, with_pen):
    return ((torch.from_numpy(lo["q"][:72]), _t(lo["codes_g"]), _t(lo["cw"]),
             _t(lo["flat"]), _t(lo["dup"]), _t(lo["vlen"][lo["flat"]]), CAP_V),
            dict(pen=_t(lo["pen"]) if with_pen else None))


@pytest.mark.parametrize("with_pen", [False, True])
@pytest.mark.parametrize("k", ["1", "20", "ncol", "ncol+5"])
def test_window_minima_selected_equal_the_full_minima_selected(layout, k,
                                                               with_pen):
    """Kernel D's entry with ``k``: the full minima, each row's k smallest
    in (value, column) order and their slots gathered, bit for bit, over the
    fixture's union (duplicate entries, windows past vlen, the pen stream);
    k' = min(k, columns), the +inf columns included in column order."""
    args, kw = _window_args(layout, with_pen)
    vmin, amin = HP.ivf_pq_window_tile_minima(*args, **kw)
    ncol = vmin.shape[1]
    kk = {"1": 1, "20": 20, "ncol": ncol, "ncol+5": ncol + 5}[k]
    sel, pos = smallest_k_plain(vmin, kk)
    vals, slots = HP.ivf_pq_window_tile_minima(*args, **kw, k=kk)
    assert vals.shape == slots.shape == (args[0].shape[0], min(kk, ncol))
    assert vals.dtype == torch.float32 and slots.dtype == torch.int32
    assert torch.equal(vals.view(torch.int32), sel.view(torch.int32))
    assert torch.equal(slots, torch.gather(amin, 1, pos))
    # independently: a stable sort of each row, sliced
    order = np.argsort(vmin.numpy(), axis=1, kind="stable")[:, :min(kk, ncol)]
    np.testing.assert_array_equal(vals.numpy(),
                                  np.take_along_axis(vmin.numpy(), order, 1))
    np.testing.assert_array_equal(slots.numpy(),
                                  np.take_along_axis(amin.numpy(), order, 1))
    if kk >= ncol:  # every column: the duplicates' +inf and slot 0 among them
        assert np.isinf(vals.numpy()).any() and (slots.numpy() == 0).any()


def test_window_selection_shape_rule():
    """D selects in its epilogue for k within its lists and more columns
    than k; otherwise the union keeps the full minima and the selection
    kernel."""
    assert HP.pq_window_selects(20, 2, 256)  # 128 columns
    assert HP.pq_window_selects(HP.PQ_WINDOW_TOPK_MAX, 16, 256)
    assert not HP.pq_window_selects(HP.PQ_WINDOW_TOPK_MAX + 1, 16, 256)
    assert not HP.pq_window_selects(20, 1, 80)  # 20 columns
    assert HP.pq_window_selects(19, 1, 80)


# (Q, D, blocks of kernel D's clusters): an even number of query blocks
# (pairs), one or an odd number (each block alone); queries past 512 dims,
# which stream through the ring (each block alone)
_CLUSTERS = [(1, 128, 1), (64, 128, 1), (128, 128, 1), (129, 128, 2), (256, 128, 2),
             (300, 128, 1), (512, 128, 2), (640, 128, 1), (896, 128, 1), (1024, 128, 2),
             (1025, 128, 1), (1100, 128, 1), (4096, 128, 2), (512, 512, 2), (512, 520, 1),
             (130, 640, 1)]


@pytest.mark.parametrize("qn,d,cluster", _CLUSTERS)
def test_window_cluster_rule(qn, d, cluster):
    """Kernel D's query blocks of 128 rows that share a slot group form
    clusters of two where they are even in number and their queries stay
    resident, so each pair decodes each tile once; otherwise each block
    decodes its own copy."""
    assert HP.pq_window_cluster(qn, d) == cluster


def _run_union(lo, qn, masked, w=4, topk=10):
    """Both packages' kernel branches in exact mode (exact probes and top-k)."""
    q = lo["q"][:qn]
    args = (lo["codes_g"], lo["norms_g"], lo["order_g"], lo["cw"],
            lo["centers_dec"], lo["centers_norms"])
    kw = dict(w=w, topk=topk, cap_u=CAP_V, nlist_pad=lo["nlist_v_pad"],
              recall_target=None)
    jkw, tkw = dict(kw), dict(kw)
    if masked:
        jkw["target_mask"] = jnp.asarray(lo["tm"])
        tkw["target_mask"] = _t(lo["tm"])
    dj, ij = JI.ivf_union_scan_topk_pq(
        jnp.asarray(q), *map(jnp.asarray, args), **jkw,
        vlen=jnp.asarray(lo["vlen"]), cw_padded=P.build_padded_codewords(lo["cw"]),
        use_pallas=True, interpret=True)
    dt, it = TI.ivf_union_scan_topk_pq(
        torch.from_numpy(q), *map(_t, args), **tkw, vlen=_t(lo["vlen"]),
        use_kernel=True, overfetch=1)
    return dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij)


@pytest.mark.parametrize("qn", [8, 64])  # either side of the Q < D gate
@pytest.mark.parametrize("masked", [False, True])
def test_union_kernel_branch_matches_pallas(layout, qn, masked, monkeypatch):
    """overfetch=1 selects as the JAX package does; both rescore exactly.
    At Q >= D kernel D selects its tile minima itself (k = topk)."""
    calls = []
    for name in ("ivf_dt_window_tile_minima", "ivf_pq_window_tile_minima"):
        real = getattr(TI, name)
        monkeypatch.setattr(TI, name, lambda *a, _r=real, _n=name, **k:
                            calls.append((_n, k.get("k"))) or _r(*a, **k))
    dt, it, dj, ij = _run_union(layout, qn, masked)
    assert calls == [("ivf_dt_window_tile_minima", None) if qn < D
                     else ("ivf_pq_window_tile_minima", 10)]
    assert_ranked_ids_match(it, dt, ij, dj, rtol=1e-5)
    if masked:
        assert layout["mask"][it[it >= 0]].all()


@pytest.mark.parametrize("overfetch", [1, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_union_selected_in_the_window_kernel_is_unchanged(layout, masked,
                                                          overfetch,
                                                          monkeypatch):
    """The union's answer with kernel D selecting its tile minima equals,
    bit for bit, the answer over its full minima and the selection kernel
    (the shape rule forced off)."""
    lo = layout
    q = torch.from_numpy(lo["q"][:64])
    args = [_t(a) for a in (lo["codes_g"], lo["norms_g"], lo["order_g"],
                            lo["cw"], lo["centers_dec"], lo["centers_norms"])]
    kw = dict(w=4, topk=10, cap_u=CAP_V, nlist_pad=lo["nlist_v_pad"],
              vlen=_t(lo["vlen"]), use_kernel=True, overfetch=overfetch,
              target_mask=_t(lo["tm"]) if masked else None)
    assert HP.pq_window_selects(10 * overfetch, 8, CAP_V)  # 64 columns
    d_f, i_f = TI.ivf_union_scan_topk_pq(q, *args, **kw)
    monkeypatch.setattr(TI, "pq_window_selects", lambda *a: False)
    d_s, i_s = TI.ivf_union_scan_topk_pq(q, *args, **kw)
    assert torch.equal(d_f.view(torch.int32), d_s.view(torch.int32))
    assert torch.equal(i_f, i_s)


def test_union_overfetch_never_loses_recall(layout):
    """overfetch=2 re-ranks a superset of the overfetch=1 candidates, so its
    k-th distance is never worse."""
    lo = layout
    q = torch.from_numpy(lo["q"][:8])
    args = [_t(a) for a in (lo["codes_g"], lo["norms_g"], lo["order_g"],
                            lo["cw"], lo["centers_dec"], lo["centers_norms"])]
    kw = dict(w=4, topk=10, cap_u=CAP_V, nlist_pad=lo["nlist_v_pad"],
              vlen=_t(lo["vlen"]), use_kernel=True)
    d1, _ = TI.ivf_union_scan_topk_pq(q, *args, **kw, overfetch=1)
    d2, i2 = TI.ivf_union_scan_topk_pq(q, *args, **kw, overfetch=2)
    assert (d2.numpy() <= d1.numpy() + 1e-6).all()
    for row in i2.numpy():
        assert len(set(row[row >= 0].tolist())) == (row >= 0).sum()


def test_union_spy_sees_the_selecting_call(layout):
    """The benchmark's spy on ops/ivf.py's name for kernel D (the union's
    live rows for scan_roofline.pq) sees the call that selects in D's
    epilogue, with the union's queries and live rows."""
    from portbench.harness.trace import UnionSpy
    lo = layout
    args = [_t(a) for a in (lo["codes_g"], lo["norms_g"], lo["order_g"],
                            lo["cw"], lo["centers_dec"], lo["centers_norms"])]
    real = TI.ivf_pq_window_tile_minima
    spy = UnionSpy()
    spy.install()
    try:
        TI.ivf_union_scan_topk_pq(
            torch.from_numpy(lo["q"][:64]), *args, w=4, topk=10, cap_u=CAP_V,
            nlist_pad=lo["nlist_v_pad"], vlen=_t(lo["vlen"]), use_kernel=True)
    finally:
        spy.remove()
    assert TI.ivf_pq_window_tile_minima is real
    ((_, qn, dup, vl),) = spy.records
    assert qn == 64 and int(vl[dup == 0].sum()) > 0
    assert spy.rows()[0][1:] == (64, int(vl[dup == 0].sum()))


# kernel D's (or its twin's) decodes of each tile a call, by Q: none at
# Q < D (kernel E), one a query block alone or a pair of them (129 to 256
# rows: one pair; 512: two)
_DECODES = {8: None, 64: 1, 256: 1, 300: 3, 512: 2, 1100: 9}


@pytest.mark.parametrize("qn,fused", [(8, 0), (64, 1), (256, 1), (300, 1), (512, 1),
                                      (1100, 1)])
def test_union_notes_whether_the_window_kernel_selected(layout, qn, fused):
    """Under a recording profiler the union's root carries ``tile_fused``
    (1 where kernel D selected its tile minima itself; kernel E, at Q < D,
    leaves them to the selection) beside ``select_kernel`` (0 on the CPU,
    where the twins select) and, where kernel D ran, ``tile_decodes``."""
    from torch.profiler import ProfilerActivity, profile

    from rii_tpu_torch.utils import profiling as prof
    lo = layout
    args = [_t(a) for a in (lo["codes_g"], lo["norms_g"], lo["order_g"],
                            lo["cw"], lo["centers_dec"], lo["centers_norms"])]
    q = lo["q"][np.arange(qn) % len(lo["q"])]  # past 128 rows, the rows again
    with profile(activities=[ProfilerActivity.CPU]):
        root = prof.begin_call("rii.query_batch")
        TI.ivf_union_scan_topk_pq(
            torch.from_numpy(q), *args, w=4, topk=10, cap_u=CAP_V,
            nlist_pad=lo["nlist_v_pad"], vlen=_t(lo["vlen"]), use_kernel=True)
        prof.end_call(root)
    attrs = [r for r in prof.spans() if r.id == root.id][0].attrs
    assert attrs["tile_fused"] == fused and attrs["select_kernel"] == 0
    assert attrs.get("tile_decodes") == _DECODES[qn]


@pytest.mark.parametrize("masked", [False, True])
def test_union_kernel_branch_ids_unique_and_padded(layout, masked):
    """Repeated queries probe the same windows (duplicate entries) and topk
    exceeds the candidates: duplicates never duplicate ids, the tail pads
    with -1 / +inf, and exact mode agrees with rii_tpu on which are padding."""
    lo = dict(layout, q=layout["q"][[0, 0, 1, 1, 2, 2, 3, 3]])
    dt, it, dj, ij = _run_union(lo, 8, masked, w=1, topk=300)
    for row in it:
        v = row[row >= 0]
        assert len(set(v.tolist())) == len(v)
    assert (it == -1).any() and np.isinf(dt[it == -1]).all()
    np.testing.assert_array_equal(it == -1, ij == -1)
    if masked:
        assert layout["mask"][it[it >= 0]].all()


def test_dt_table_needs_the_card(layout):
    """The table-only entry launches a CUDA kernel: CPU tensors raise."""
    with pytest.raises(ValueError):
        HP.dt_table(torch.from_numpy(layout["q"][:8]), _t(layout["cw"]))
