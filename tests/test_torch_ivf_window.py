"""Kernel B's module (the IVF window scan) and the union IVF op of
rii_tpu_torch against rii_tpu in Pallas interpret mode.

On the CPU the port runs kernel B's plain twin. Window values are scaled so
that real scores stay below 2 in magnitude, where one packed-key step lies
inside the stated 1e-5 + 1e-5*|s| tolerance (see test_torch_replica_scan)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rii_tpu.ops import ivf as JI
from rii_tpu.ops import pallas_scan as P
from rii_tpu_torch.models.ivf import build_virtual_layout, code_norms_np
from rii_tpu_torch.ops import hopper_scan as H
from rii_tpu_torch.ops import ivf as TI

from _torch_parity import assert_keys_match, assert_ranked_ids_match

D, M, KS, CAP_V = 64, 8, 32, 32


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def windows():
    """Random windows with sentinel padding rows, a sorted union with
    duplicates, and a 0/+inf penalty stream."""
    rng = np.random.RandomState(4)
    nwin, u, qn = 24, 40, 8
    dec = (rng.random((nwin * CAP_V, D)) * 0.08).astype(np.float32)
    dec[rng.random(nwin * CAP_V) < 0.2] = 1e15
    dec16 = jnp.asarray(dec, jnp.bfloat16)
    flat = np.sort(rng.randint(0, nwin, u)).astype(np.int32)
    dup = np.concatenate([[0], flat[1:] == flat[:-1]]).astype(np.int32)
    assert dup.sum() > 0
    pen = np.where(rng.random(nwin * CAP_V) < 0.3, np.inf, 0).astype(np.float32)
    q = (rng.random((qn, D)) * 0.08).astype(np.float32)
    dec_t = torch.tensor(np.asarray(dec16.astype(jnp.float32))).to(torch.bfloat16)
    return dict(dec16=dec16, dec_t=dec_t, flat=flat, dup=dup, pen=pen, q=q)


@pytest.mark.parametrize("with_pen", [False, True])
def test_window_top2_matches_pallas(windows, with_pen):
    w = windows
    pen = w["pen"] if with_pen else None
    vj, aj = P.ivf_window_tile_minima(
        jnp.asarray(w["q"]), w["dec16"], jnp.asarray(w["flat"]),
        jnp.asarray(w["dup"]), cap_v=CAP_V, interpret=True,
        pen=None if pen is None else jnp.asarray(pen)[:, None])
    vt, at = H.ivf_window_tile_minima(
        torch.from_numpy(w["q"]), w["dec_t"], _t(w["flat"]), _t(w["dup"]),
        CAP_V, pen=None if pen is None else _t(pen))
    vj, aj, vt, at = map(np.asarray, (vj, aj, vt, at))
    assert vt.shape == (8, len(w["flat"]) * 2 * CAP_V // 8) and at.dtype == np.int32
    fin = np.isfinite(vj)
    assert np.abs(vt[fin & (vt < 1e6)]).max() < 2.0
    assert_keys_match(vt, at, vj, aj)
    # duplicate entries: nothing scored, +inf and slot 0
    cols = np.repeat(w["dup"] != 0, 2 * CAP_V // 8)
    assert np.isinf(vt[:, cols]).all() and (at[:, cols] == 0).all()


def test_window_top2_takes_any_d(windows):
    """Odd D (the JAX package's multi-window kernel needs D % 128 == 0)."""
    w = windows
    d = 37
    dec = w["dec_t"][:, :d].contiguous()
    vj, aj = P.ivf_window_tile_minima(
        jnp.asarray(w["q"][:, :d]), jnp.asarray(dec.float().numpy(), jnp.bfloat16),
        jnp.asarray(w["flat"]), jnp.asarray(w["dup"]), cap_v=CAP_V,
        interpret=True)
    vt, at = H.ivf_window_tile_minima(torch.from_numpy(w["q"][:, :d]), dec,
                                      _t(w["flat"]), _t(w["dup"]), CAP_V)
    assert_keys_match(vt.numpy(), at.numpy(), np.asarray(vj), np.asarray(aj))


@pytest.fixture(scope="module")
def union():
    return _make_union()


def _make_union():
    """A grouped layout built by the shared virtual-layout code, with the
    engine's bf16 windows (sentinel padding) and its virtual centers."""
    rng = np.random.RandomState(6)
    n, nlist = 3000, 12
    cw = (rng.random((M, KS, D // M)) * 0.1).astype(np.float32)
    codes = rng.randint(0, KS, (n, M)).astype(np.uint8)
    assign = rng.randint(0, nlist, n).astype(np.int32)
    norms = code_norms_np(cw, codes)
    ul = build_virtual_layout(codes, norms, assign, nlist, cap_v=CAP_V)
    order = ul["order"]
    grouped = cw[np.arange(M)[None, :], ul["codes_grouped"].astype(np.int64)]
    grouped = grouped.reshape(len(order), D)
    grouped[order < 0] = 1e15
    centers = cw[np.arange(M)[None, :], rng.randint(0, KS, (nlist, M))].reshape(nlist, D)
    vr = np.clip(ul["vreal"], 0, nlist - 1)
    cdv = centers[vr].astype(np.float32)
    cnv = np.where(ul["vreal"] >= 0, (centers[vr] ** 2).sum(1), np.inf).astype(np.float32)
    q = (codes_to_rows(cw, codes[:16]) + rng.normal(0, 0.01, (16, D))).astype(np.float32)
    arrays = dict(decoded_g=grouped, norms_g=ul["norms_grouped"], order_g=order,
                  centers_dec=cdv, centers_norms=cnv)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, 1200, replace=False)] = True
    tm = mask[np.clip(order, 0, n - 1)]
    return dict(arrays=arrays, q=q, codes=codes, cw=cw, tm=tm, mask=mask,
                nlist_v_pad=ul["nlist_v_pad"])


def codes_to_rows(cw, codes):
    return cw[np.arange(M)[None, :], codes.astype(np.int64)].reshape(len(codes), -1)


def _run_both(u, w, topk, recall_target, kernel, rescore, masked):
    a = u["arrays"]
    jargs = [jnp.asarray(u["q"]), jnp.asarray(a["decoded_g"], jnp.bfloat16),
             jnp.asarray(a["norms_g"]), jnp.asarray(a["order_g"]),
             jnp.asarray(a["centers_dec"]), jnp.asarray(a["centers_norms"])]
    targs = [torch.from_numpy(u["q"]),
             torch.tensor(np.asarray(jargs[1].astype(jnp.float32))).to(torch.bfloat16),
             _t(a["norms_g"]), _t(a["order_g"]), _t(a["centers_dec"]),
             _t(a["centers_norms"])]
    common = dict(w=w, topk=topk, cap_u=CAP_V, nlist_pad=u["nlist_v_pad"],
                  recall_target=recall_target)
    jkw, tkw = dict(common), dict(common)
    if masked:
        jkw["target_mask"] = jnp.asarray(u["tm"])
        tkw["target_mask"] = _t(u["tm"])
    if rescore:
        jkw.update(codes=jnp.asarray(u["codes"]), codewords=jnp.asarray(u["cw"]))
        tkw.update(codes=_t(u["codes"]), codewords=_t(u["cw"]))
    dj, ij = JI.ivf_union_scan_topk(*jargs, **jkw, use_pallas=kernel,
                                    interpret=kernel)
    dt, it = TI.ivf_union_scan_topk(*targs, **tkw, use_kernel=kernel)
    return dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij)


@pytest.mark.parametrize("rescore,masked", [(True, False), (False, False),
                                            (True, True)])
def test_union_kernel_branch_matches_pallas(union, rescore, masked):
    dt, it, dj, ij = _run_both(union, w=4, topk=10, recall_target=0.99,
                               kernel=True, rescore=rescore, masked=masked)
    assert_ranked_ids_match(it, dt, ij, dj, rtol=1e-5)
    if masked:
        assert union["mask"][it[it >= 0]].all()


@pytest.mark.parametrize("rescore,masked", [(False, False), (True, True)])
def test_union_plain_branch_matches_jax(union, rescore, masked):
    dt, it, dj, ij = _run_both(union, w=4, topk=10, recall_target=None,
                               kernel=False, rescore=rescore, masked=masked)
    assert_ranked_ids_match(it, dt, ij, dj, rtol=1e-5)


@pytest.mark.parametrize("recall_target", [None, 0.99])
def test_union_ids_unique_and_padded(union, recall_target):
    """Duplicate windows never duplicate ids; a union too small for topk
    pads with -1 / +inf. The port's selection is exact at any
    recall_target, so it never returns fewer candidates than rii_tpu (whose
    approx_max_k drops some at this k on the CPU), and exactly as many in
    exact mode."""
    dt, it, dj, ij = _run_both(union, w=1, topk=300,
                               recall_target=recall_target, kernel=True,
                               rescore=False, masked=True)
    for row in it:
        v = row[row >= 0]
        assert len(set(v.tolist())) == len(v)
    assert (it == -1).any() and np.isinf(dt[it == -1]).all()
    if recall_target is None:
        np.testing.assert_array_equal(it == -1, ij == -1)
    else:
        assert ((it >= 0).sum(1) >= (ij >= 0).sum(1)).all()


@pytest.mark.parametrize("recall_target", [None, 0.99])
def test_union_pq_plain_branch_matches_jax(union, recall_target):
    u, a = union, union["arrays"]
    grouped_codes = np.zeros((len(a["order_g"]), M), np.uint8)
    valid = a["order_g"] >= 0
    grouped_codes[valid] = u["codes"][a["order_g"][valid]]
    args = (grouped_codes, a["norms_g"], a["order_g"], u["cw"],
            a["centers_dec"], a["centers_norms"])
    kw = dict(w=4, topk=10, cap_u=CAP_V, nlist_pad=u["nlist_v_pad"],
              recall_target=recall_target)
    dj, ij = JI.ivf_union_scan_topk_pq(jnp.asarray(u["q"]),
                                       *map(jnp.asarray, args), **kw)
    dt, it = TI.ivf_union_scan_topk_pq(torch.from_numpy(u["q"]),
                                       *map(_t, args), **kw)
    assert_ranked_ids_match(it.numpy(), dt.numpy(), np.asarray(ij),
                            np.asarray(dj), rtol=1e-5)
