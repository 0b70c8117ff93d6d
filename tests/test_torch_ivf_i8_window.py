"""Kernel G's module (the int8 tier's IVF window scan) and the int8 union IVF
op of rii_tpu_torch against rii_tpu in Pallas interpret mode.

On the CPU the port runs kernel G's plain twin. Codewords are scaled so
that real scores stay below 2 in magnitude, where one packed-key step lies
inside the stated 1e-5 + 1e-5*|s| tolerance (see test_torch_replica_scan);
the window norms are float32 sums in another order than XLA's. The JAX
side runs under jit, as the JAX engine runs it."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rii_tpu.ops import ivf as JI
from rii_tpu.ops import pallas_scan as P
from rii_tpu.ops.decode import build_decoded_cache
from rii_tpu_torch.models.ivf import build_virtual_layout, code_norms_np
from rii_tpu_torch.ops import hopper_i8 as HI
from rii_tpu_torch.ops import ivf as TI

from _torch_parity import assert_keys_match, assert_ranked_ids_match

D, M, KS, CAP_V = 64, 8, 32, 32
_jax_windows = jax.jit(partial(P.ivf_i8_window_tile_minima, interpret=True),
                       static_argnames=("cap_v",))


def _t(a):
    return torch.tensor(np.asarray(a))


def _make_layout(d, m):
    """A grouped layout built by the shared virtual-layout code (so windows
    end in padding: vlen < cap_v), the int8 windows quantized by both
    packages over every slot, the virtual centers, a subset mask in grouped
    order and a sorted union with duplicates."""
    rng = np.random.RandomState(17)
    n, nlist = 3000, 12
    cw = (rng.random((m, KS, d // m)) * 0.1).astype(np.float32)
    codes = rng.randint(0, KS, (n, m)).astype(np.uint8)
    assign = rng.randint(0, nlist, n).astype(np.int32)
    norms = code_norms_np(cw, codes)
    ul = build_virtual_layout(codes, norms, assign, nlist, cap_v=CAP_V,
                              headroom=0.125)
    assert (ul["vlen"][:ul["nlist_v"]] < CAP_V).any()
    dec_g = build_decoded_cache(jnp.asarray(ul["codes_grouped"]),
                                jnp.asarray(cw), block=CAP_V)
    g_j, s_j = P.quantize_replica_i8(dec_g)
    g_t, s_t = HI.quantize_replica_i8(_t(ul["codes_grouped"]), _t(cw))
    order = ul["order"]
    centers = cw[np.arange(m)[None, :], rng.randint(0, KS, (nlist, m))].reshape(nlist, d)
    vr = np.clip(ul["vreal"], 0, nlist - 1)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, 1200, replace=False)] = True
    nwin = ul["nlist_v_pad"]
    flat = np.sort(rng.randint(0, nwin, 40)).astype(np.int32)
    dup = np.concatenate([[0], flat[1:] == flat[:-1]]).astype(np.int32)
    assert dup.sum() > 0
    rows = cw[np.arange(m)[None, :], codes[:128].astype(np.int64)].reshape(128, d)
    q = (rows + rng.normal(0, 0.01, (128, d))).astype(np.float32)
    return dict(
        cw=cw, codes=codes, mask=mask, q=q, flat=flat, dup=dup,
        g_j=np.asarray(g_j), s_j=np.asarray(s_j), g_t=g_t, s_t=s_t,
        norms_g=ul["norms_grouped"], order_g=order, vlen=ul["vlen"],
        nlist_v_pad=nwin, centers_dec=centers[vr].astype(np.float32),
        centers_norms=np.where(ul["vreal"] >= 0, (centers[vr] ** 2).sum(1),
                               np.inf).astype(np.float32),
        pen=np.where(mask[np.clip(order, 0, n - 1)] & (order >= 0), 0.0,
                     np.inf).astype(np.float32),
        tm=mask[np.clip(order, 0, n - 1)])


@pytest.fixture(scope="module")
def layout():
    return _make_layout(D, M)


@pytest.fixture(scope="module")
def layout_d30():
    """D=30 (M=10, Ds=3): not a multiple of 4, where rii_tpu runs the
    single-window kernel K6s."""
    return _make_layout(30, 10)


def test_quantized_windows_equal_jax_bit_for_bit(layout):
    """The grouped decode quantized over every slot, padding included."""
    np.testing.assert_array_equal(layout["g_t"].numpy(), layout["g_j"])
    np.testing.assert_array_equal(layout["s_t"].numpy(), layout["s_j"])


@pytest.mark.parametrize("qn", [8, 72])  # one pass of 32 queries, three
@pytest.mark.parametrize("with_pen", [False, True])
def test_window_top2_matches_pallas(layout, qn, with_pen):
    lo = layout
    q = lo["q"][:qn]
    pen = lo["pen"] if with_pen else None
    vl = lo["vlen"][lo["flat"]]
    vj, aj = _jax_windows(jnp.asarray(q), jnp.asarray(lo["g_j"]),
                          jnp.asarray(lo["s_j"]), jnp.asarray(lo["flat"]),
                          jnp.asarray(lo["dup"]), jnp.asarray(vl), cap_v=CAP_V,
                          pen=None if pen is None else jnp.asarray(pen)[:, None])
    vt, at = HI.ivf_i8_window_tile_minima(
        torch.from_numpy(q), lo["g_t"], lo["s_t"], _t(lo["flat"]),
        _t(lo["dup"]), _t(vl), CAP_V, pen=None if pen is None else _t(pen))
    vj, aj, vt, at = map(np.asarray, (vj, aj, vt, at))
    assert vt.shape == (qn, len(lo["flat"]) * 2 * CAP_V // 8) and at.dtype == np.int32
    fin = np.isfinite(vt)
    assert np.abs(vt[fin]).max() < 2.0
    assert_keys_match(vt, at, vj, aj)
    # duplicate entries: nothing scored, +inf and slot 0
    cols = np.repeat(lo["dup"] != 0, 2 * CAP_V // 8)
    assert np.isinf(vt[:, cols]).all() and (at[:, cols] == 0).all()
    # rows past the member count never come back
    win = at[fin] // CAP_V
    assert ((at[fin] % CAP_V) < lo["vlen"][win]).all()
    if with_pen:
        assert (lo["pen"][at[fin]] == 0).all()


def _window_twin_against_pallas(lo, qn, with_pen):
    q = lo["q"][:qn]
    pen = lo["pen"] if with_pen else None
    vl = lo["vlen"][lo["flat"]]
    vj, aj = _jax_windows(jnp.asarray(q), jnp.asarray(lo["g_j"]),
                          jnp.asarray(lo["s_j"]), jnp.asarray(lo["flat"]),
                          jnp.asarray(lo["dup"]), jnp.asarray(vl), cap_v=CAP_V,
                          pen=None if pen is None else jnp.asarray(pen)[:, None])
    vt, at = HI.ivf_i8_window_tile_minima(
        torch.from_numpy(q), lo["g_t"], lo["s_t"], _t(lo["flat"]),
        _t(lo["dup"]), _t(vl), CAP_V, pen=None if pen is None else _t(pen))
    assert vt.shape == (qn, len(lo["flat"]) * 2 * CAP_V // 8)
    assert_keys_match(*map(np.asarray, (vt, at, vj, aj)))


@pytest.mark.parametrize("qn", [1, 8, 63, 64, 65, 127])
def test_window_twin_matches_pallas_over_q(layout, qn):
    """Kernel G's twin (what the kernel is held to on the card) from one
    query to past the kernel's 128-row query block, with the pen stream on
    every other Q."""
    _window_twin_against_pallas(layout, qn, qn % 2 == 1)


@pytest.mark.parametrize("qn", [8, 65])
def test_window_twin_matches_pallas_ragged_d(layout_d30, qn):
    """D=30, not a multiple of 4 (rii_tpu's K6s); the windows quantized by
    both packages agree bit for bit there too."""
    lo = layout_d30
    np.testing.assert_array_equal(lo["g_t"].numpy(), lo["g_j"])
    _window_twin_against_pallas(lo, qn, qn == 65)


def _run_union(lo, qn, masked, w=4, topk=10):
    """Both packages' int8 union IVF in exact mode (exact probes, top-k)."""
    q = lo["q"][:qn]
    kw = dict(w=w, topk=topk, cap_u=CAP_V, nlist_pad=lo["nlist_v_pad"],
              recall_target=None)
    rest = (lo["norms_g"], lo["order_g"], lo["codes"], lo["cw"],
            lo["centers_dec"], lo["centers_norms"])
    dj, ij = JI.ivf_union_scan_topk_i8(
        jnp.asarray(q), jnp.asarray(lo["g_j"]), jnp.asarray(lo["s_j"]),
        *map(jnp.asarray, rest), **kw, vlen=jnp.asarray(lo["vlen"]),
        target_mask=jnp.asarray(lo["tm"]) if masked else None, interpret=True)
    dt, it = TI.ivf_union_scan_topk_i8(
        torch.from_numpy(q), lo["g_t"], lo["s_t"], *map(_t, rest),
        _t(lo["vlen"]), **kw, target_mask=_t(lo["tm"]) if masked else None)
    return dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij)


@pytest.mark.parametrize("qn", [8, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_union_matches_pallas(layout, qn, masked, monkeypatch):
    """Kernel G's twin selects, both rescore exactly from the codes through
    order_g: exact-ADC distances, ids per rank (ties aside)."""
    calls = []
    real = TI.ivf_i8_window_tile_minima
    monkeypatch.setattr(TI, "ivf_i8_window_tile_minima",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    dt, it, dj, ij = _run_union(layout, qn, masked)
    assert calls == [1]
    assert_ranked_ids_match(it, dt, ij, dj, rtol=1e-5)
    if masked:
        assert layout["mask"][it[it >= 0]].all()


@pytest.mark.parametrize("masked", [False, True])
def test_union_ids_unique_and_padded(layout, masked):
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


def test_union_padding_rows_never_crowd_out_members(layout):
    """Padding rows hold the quantized decode of code 0: a query at that
    point scores them best. With every window probed, masked by vlen in
    the kernel, they never take the overfetched candidates' places, so the
    results equal rii_tpu's."""
    lo = layout
    zero = lo["cw"][:, 0, :].reshape(1, D)
    q = np.repeat(zero, 8, axis=0).astype(np.float32)
    dt, it, dj, ij = _run_union(dict(lo, q=q), 8, False, w=lo["nlist_v_pad"])
    assert (it >= 0).all()
    assert_ranked_ids_match(it, dt, ij, dj, rtol=1e-5)


def test_cpu_twin_launches_nothing(layout):
    lo = layout
    before = HI.ivf_i8_window_tile_minima.launches
    HI.ivf_i8_window_tile_minima(torch.zeros((2, D)), lo["g_t"], lo["s_t"],
                                 _t(lo["flat"]), _t(lo["dup"]),
                                 _t(lo["vlen"][lo["flat"]]), CAP_V)
    assert HI.ivf_i8_window_tile_minima.launches == before


def test_wrapper_rejects_bad_shapes(layout):
    lo = layout
    args = (lo["g_t"], lo["s_t"], _t(lo["flat"]), _t(lo["dup"]),
            _t(lo["vlen"][lo["flat"]]))
    with pytest.raises(ValueError):
        HI.ivf_i8_window_tile_minima(torch.zeros((2, D + 1)), *args, CAP_V)
    with pytest.raises(ValueError):
        HI.ivf_i8_window_tile_minima(torch.zeros((2, D)), *args, 12)
