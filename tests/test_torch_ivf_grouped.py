"""The whole-bucket grouped layout (rii_tpu_torch.models.ivf
.build_grouped_layout) and the IVF ops over it (rii_tpu_torch.ops.ivf
.ivf_scan_topk, float32, and ivf_scan_topk_decoded, bf16 cross terms)
against rii_tpu's on the same seeded inputs.

The layout must be bit-equal. The scans must rank the same ids (ties
aside) with distances within 1e-5 relative: the f32 scan, and the decoded
one too, whose bf16 products are exact in float32 on both sides and whose
sums differ only in order (the tolerance tests/test_torch_ivf_window.py
holds the bf16 window scan to)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rii_tpu.models import ivf as JM
from rii_tpu.ops import ivf as JI
from rii_tpu_torch.models import ivf as TM
from rii_tpu_torch.ops import ivf as TI
from rii_tpu_torch.ops.decode import onehot_decode
from rii_tpu_torch.ops.scan import linear_scan_topk, linear_scan_topk_decoded

from _torch_parity import assert_ranked_ids_match

N, D, M, KS, NLIST, NLIST_PAD = 3000, 32, 8, 32, 24, 32
RTOL = 1e-5
I32_MAX = np.iinfo(np.int32).max


def _rows(cw, codes):
    return cw[np.arange(M)[None, :], codes.astype(np.int64)].reshape(len(codes), -1)


def _layout(unassigned):
    """Codes assigned to their nearest center; cluster 3 gets no member and,
    with ``unassigned``, every 10th id is in no posting list (-1)."""
    rng = np.random.RandomState(8)
    cw = (rng.random((M, KS, D // M)) * 0.1).astype(np.float32)
    codes = rng.randint(0, KS, (N, M)).astype(np.uint8)
    centers = _rows(cw, rng.randint(0, KS, (NLIST, M)))
    x = _rows(cw, codes)
    dist = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
    dist[:, 3] = np.inf
    assign = dist.argmin(1).astype(np.int64)
    if unassigned:
        assign[::10] = -1
    norms = TM.code_norms_np(cw, codes)
    return cw, codes, centers, assign, norms


@pytest.mark.parametrize("unassigned", [False, True])
def test_grouped_layout_bit_equal(unassigned):
    cw, codes, _, assign, norms = _layout(unassigned)
    lt = TM.build_grouped_layout(codes, norms, assign, NLIST)
    lj = JM.build_grouped_layout(codes, norms, assign, NLIST)
    assert set(lt) == set(lj)
    for k in lj:
        if isinstance(lj[k], np.ndarray):
            assert lt[k].dtype == lj[k].dtype, k
            np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)
        else:
            assert lt[k] == lj[k], k
    assert lt["bucket_len"][3] == 0
    order = lt["order"]
    assert set(order[order >= 0].tolist()) == set(np.nonzero(assign >= 0)[0].tolist())
    for c in range(NLIST):  # ids ascend within a bucket
        s, n = lt["bucket_start"][c], lt["bucket_len"][c]
        assert (np.diff(order[s:s + n]) > 0).all()
        assert (lt["slot_cluster"][s:s + n] == c).all()
    # a tail window of cap_max slots keeps every probe in bounds
    assert lt["total"] >= int(lt["bucket_start"][-1]) + lt["cap_max"]


@pytest.fixture(scope="module", params=[False, True], ids=["all", "unassigned"])
def grouped(request):
    cw, codes, centers, assign, norms = _layout(request.param)
    lay = TM.build_grouped_layout(codes, norms, assign, NLIST)
    bucket_start = np.zeros(NLIST_PAD, np.int32)
    bucket_start[:NLIST] = lay["bucket_start"]
    cdec = np.zeros((NLIST_PAD, D), np.float32)
    cdec[:NLIST] = centers
    cnorm = np.full(NLIST_PAD, np.inf, np.float32)
    cnorm[:NLIST] = (centers ** 2).sum(1)
    rng = np.random.RandomState(9)
    q = (_rows(cw, codes[:12]) + rng.normal(0, 0.01, (12, D))).astype(np.float32)
    dec16 = jnp.asarray(_rows(cw, codes), jnp.bfloat16)
    return dict(cw=cw, codes=codes, norms=norms, lay=lay, q=q, dec16=dec16,
                arrays=dict(centers_dec=cdec, centers_norms=cnorm,
                            bucket_start=bucket_start),
                unassigned=request.param)


def _subset(size):
    tids = np.sort(np.random.RandomState(10).choice(N, size, replace=False))
    pad = np.full(-(-size // 16) * 16 + 16, I32_MAX, np.int32)
    pad[:size] = tids
    return tids, pad


def _scan(g, w, topk, subset=None, decoded=False):
    """(dists, ids) of rii_tpu's and of the port's scan on the same layout."""
    lay, a = g["lay"], g["arrays"]
    common = [a["centers_dec"], a["centers_norms"], a["bucket_start"]]
    tail = [lay["norms_grouped"], lay["order"], lay["slot_cluster"]]
    jkw = dict(w=w, topk=topk, cap_max=lay["cap_max"])
    tkw = dict(jkw)
    if subset is not None:
        jkw.update(target_ids=jnp.asarray(subset[1]), n_targets=jnp.int32(len(subset[0])))
        tkw.update(target_ids=torch.from_numpy(subset[1]), n_targets=len(subset[0]))
    q = g["q"]
    if decoded:
        dj, ij = JI.ivf_scan_topk_decoded(jnp.asarray(q), g["dec16"],
                                          *map(jnp.asarray, common + tail), **jkw)
        dec_t = torch.from_numpy(np.array(g["dec16"].astype(jnp.float32))).to(torch.bfloat16)
        dt, it = TI.ivf_scan_topk_decoded(torch.from_numpy(q), dec_t,
                                          *map(torch.from_numpy, common + tail), **tkw)
    else:
        dj, ij = JI.ivf_scan_topk(jnp.asarray(q), jnp.asarray(g["cw"]),
                                  *map(jnp.asarray, common),
                                  jnp.asarray(lay["codes_grouped"]),
                                  *map(jnp.asarray, tail), **jkw)
        dt, it = TI.ivf_scan_topk(torch.from_numpy(q), torch.from_numpy(g["cw"]),
                                  *map(torch.from_numpy, common),
                                  torch.from_numpy(lay["codes_grouped"]),
                                  *map(torch.from_numpy, tail), **tkw)
    assert dt.dtype == torch.float32 and it.dtype == torch.int64
    return np.asarray(dj), np.asarray(ij), dt.numpy(), it.numpy()


@pytest.mark.parametrize("decoded", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("w,topk", [(1, 10), (3, 10), (1, 300), (5, 300)])
def test_ivf_scan_matches_rii_tpu(grouped, decoded, w, topk):
    dj, ij, dt, it = _scan(grouped, w, topk, decoded=decoded)
    assert_ranked_ids_match(it, dt, ij, dj, rtol=RTOL)
    np.testing.assert_array_equal(it == -1, ij == -1)  # padding: -1 / +inf
    assert np.isinf(dt[it == -1]).all()
    if (w, topk) == (1, 300):  # one bucket holds fewer than 300
        assert (it == -1).any()
    for row in it:  # ids unique, none left out of the posting lists
        v = row[row >= 0]
        assert len(set(v.tolist())) == len(v)
        if grouped["unassigned"]:
            assert (v % 10 != 0).all()


@pytest.mark.parametrize("decoded", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("size", [40, 700])
def test_ivf_scan_subset_padded_with_int32_max(grouped, decoded, size):
    subset = _subset(size)
    dj, ij, dt, it = _scan(grouped, 6, 10, subset=subset, decoded=decoded)
    assert_ranked_ids_match(it, dt, ij, dj, rtol=RTOL)
    assert np.isin(it[it >= 0], subset[0]).all()


@pytest.mark.parametrize("decoded", [False, True], ids=["f32", "bf16"])
def test_full_width_equals_the_linear_scan(grouped, decoded):
    """w = nlist probes every posting list: the linear scan's answer over
    the ids in the lists (the ops-level analogue of
    tests/test_ivf_decoded.py::test_engine_routes_to_decoded_ivf)."""
    g = grouped
    _, _, dt, it = _scan(g, NLIST, 10, decoded=decoded)
    q = torch.from_numpy(g["q"])
    norms = torch.from_numpy(g["norms"].copy())
    if g["unassigned"]:
        norms[::10] = float("inf")
    codes, cw = torch.from_numpy(g["codes"]), torch.from_numpy(g["cw"])
    if decoded:
        dl, il = linear_scan_topk_decoded(q, onehot_decode(codes, cw, torch.bfloat16),
                                          norms, 10)
    else:
        dl, il = linear_scan_topk(q, codes, norms, cw, 10)
    assert_ranked_ids_match(it, dt, il.numpy(), dl.numpy(), rtol=RTOL)


def test_slots_past_int32_are_indexed_in_int64():
    """Window slots are formed in int64 (bucket starts past 2^31 - cap_max
    would wrap in int32)."""
    starts = torch.tensor([2**31 - 4, 0], dtype=torch.int32)
    cs = torch.tensor([[0.0, 1.0]])
    slots, expect = TI._bucket_windows(cs, starts, 1, 8)
    assert slots.dtype == torch.int64
    assert slots[0, -1].item() == 2**31 + 3 and (expect == 0).all()
