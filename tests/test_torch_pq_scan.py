"""Kernel C's module (rii_tpu_torch.ops.hopper_pq, the linear scan of the
pq tier) and build_dtable against rii_tpu in Pallas interpret mode.

On the CPU the port's wrapper runs kernel C's plain twin. Codewords and
queries are scaled so that scores stay below 2 in magnitude, where one step
of the packed keys (2^-16 relative) lies inside the stated 1e-5 + 1e-5*|s|
tolerance (see test_torch_replica_scan)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rii_tpu.models.ivf import code_norms_np
from rii_tpu.ops import pallas_scan as P
from rii_tpu_torch.ops import hopper_pq as HP
from rii_tpu_torch.ops.decode import build_dtable, codeword_norms

from _torch_parity import assert_keys_match, assert_ranked_ids_match, unpack

D, CAP, M, KS = 64, 4096, 8, 32


@pytest.fixture(scope="module")
def scan():
    """Codes, codewords (values below 0.1) and norms with +inf on the 96
    padding slots, in both packages' layouts."""
    rng = np.random.RandomState(13)
    cw = (rng.random((M, KS, D // M)) * 0.1).astype(np.float32)
    codes = rng.randint(0, KS, (CAP, M)).astype(np.uint8)
    norms = code_norms_np(cw, codes)
    norms[-96:] = np.inf
    codes_t, norms_t = HP.prepare_pq_scan_inputs_t(torch.from_numpy(codes),
                                                   torch.from_numpy(norms))
    return dict(cw=cw, codes=codes, norms=norms, codes_t=codes_t,
                norms_t=norms_t, rng=rng)


def _jax_run(s, q, norms, topk):
    ct, n2, cwt = P.prepare_pq_scan_inputs_t(s["codes"], norms, s["cw"], cap=CAP)
    d, i = P.pq_scan_topk_t(jnp.asarray(q), ct, n2, cwt, topk=topk,
                            interpret=True, recall_target=None)
    return np.asarray(d), np.asarray(i)


def _queries(rng, qn):
    return (rng.random((qn, D)) * 0.1).astype(np.float32)


def _masked_norms(s):
    keep = np.zeros(CAP, bool)
    keep[s["rng"].choice(CAP - 96, 1500, replace=False)] = True
    return np.where(keep, s["norms"], np.inf).astype(np.float32), keep


@pytest.mark.parametrize("qn", [8, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_tile_keys_match_pallas(scan, qn, masked):
    """Every tile's key of the twin against the Pallas kernel's (recovered
    by a merge over all CAP/128 tiles, which returns each tile's minimum)."""
    q = _queries(scan["rng"], qn)
    norms = _masked_norms(scan)[0] if masked else scan["norms"]
    dj, ij = _jax_run(scan, q, norms, CAP // 128)
    qsq = (q.astype(np.float32) ** 2).sum(1)
    vj = np.full((qn, CAP // 128), np.inf, np.float32)
    lj = np.zeros((qn, CAP // 128), np.int32)
    rows, cols = np.nonzero(ij >= 0)
    vj[rows, ij[rows, cols] // 128] = dj[rows, cols] - qsq[rows]
    lj[rows, ij[rows, cols] // 128] = ij[rows, cols] % 128
    kt = HP.pq_tile_keys(torch.from_numpy(q), scan["codes_t"],
                         torch.from_numpy(norms), torch.from_numpy(scan["cw"]))
    assert kt.shape == (qn, CAP // 128)
    vt, lt = unpack(kt.numpy(), 0x7F)
    assert np.abs(vt[np.isfinite(vt)]).max() < 2.0  # see the module docstring
    assert_keys_match(vt, lt, vj, lj)


@pytest.mark.parametrize("qn", [8, 128])
def test_topk_matches_pallas(scan, qn):
    """Selection only, as in JAX: ids per rank (near-ties aside), distances
    at key precision."""
    q = _queries(scan["rng"], qn)
    dj, ij = _jax_run(scan, q, scan["norms"], 5)
    d, i = HP.pq_scan_topk_t(torch.from_numpy(q), scan["codes_t"],
                             scan["norms_t"], torch.from_numpy(scan["cw"]), 5)
    assert i.dtype == torch.int64
    assert_ranked_ids_match(i.numpy(), d.numpy(), ij, dj, rtol=1e-5)


def test_masked_norms_keep_the_subset(scan):
    """A subset folded into the norms as +inf: only its ids come back."""
    q = _queries(scan["rng"], 8)
    norms, keep = _masked_norms(scan)
    dj, ij = _jax_run(scan, q, norms, 5)
    d, i = HP.pq_scan_topk_t(torch.from_numpy(q), scan["codes_t"],
                             torch.from_numpy(norms),
                             torch.from_numpy(scan["cw"]), 5)
    assert keep[i.numpy()].all()
    assert_ranked_ids_match(i.numpy(), d.numpy(), ij, dj, rtol=1e-5)


def test_padding_only_tiles_return_minus_one(scan):
    nm = np.full(CAP, np.inf, np.float32)
    nm[:3] = scan["norms"][:3]
    d, i = HP.pq_scan_topk_t(torch.zeros((2, D)), scan["codes_t"],
                             torch.from_numpy(nm), torch.from_numpy(scan["cw"]), 4)
    assert (i[:, 0] >= 0).all() and (i[:, 1:] == -1).all()
    assert torch.isinf(d[:, 1:]).all()


def test_prepare_pads_codes_and_norms(scan):
    ct, nm = HP.prepare_pq_scan_inputs_t(torch.from_numpy(scan["codes"][:300]),
                                         torch.from_numpy(scan["norms"][:300]))
    assert ct.shape == (M, 384) and ct.is_contiguous() and ct.dtype == torch.uint8
    np.testing.assert_array_equal(ct[:, :300].numpy(), scan["codes"][:300].T)
    assert (ct[:, 300:] == 0).all() and torch.isinf(nm[300:]).all()


def test_cpu_twin_launches_nothing_and_rejects_bad_shapes(scan):
    before = HP.pq_tile_keys.launches
    HP.pq_tile_keys(torch.zeros((2, D)), scan["codes_t"], scan["norms_t"],
                    torch.from_numpy(scan["cw"]))
    assert HP.pq_tile_keys.launches == before
    with pytest.raises(ValueError):
        HP.pq_tile_keys(torch.zeros((2, D + 8)), scan["codes_t"],
                        scan["norms_t"], torch.from_numpy(scan["cw"]))
    with pytest.raises(ValueError):
        HP.pq_tile_keys(torch.zeros((2, D)), scan["codes_t"][:, :100],
                        scan["norms_t"][:100], torch.from_numpy(scan["cw"]))


@pytest.mark.parametrize("qn", [8, 128])
def test_build_dtable_bf16_equal(qn):
    """The table of kernel E rounds to the same bf16 values as the JAX one."""
    rng = np.random.RandomState(qn)
    cw = rng.standard_normal((M, KS, D // M)).astype(np.float32)
    q = rng.standard_normal((qn, D)).astype(np.float32)
    tj = np.asarray(P.build_dtable(jnp.asarray(q), jnp.asarray(cw)).astype(jnp.float32))
    tt = build_dtable(torch.from_numpy(q), torch.from_numpy(cw))
    assert tt.dtype == torch.bfloat16 and tt.shape == (M, KS, qn)
    np.testing.assert_array_equal(tt.float().numpy(), tj)


@pytest.mark.parametrize("qn", [8, 128])
def test_build_dtable_cached_codeword_norms(qn):
    """With the codeword norms computed once (as the engine caches them),
    the table is still the JAX one, bit for bit."""
    rng = np.random.RandomState(100 + qn)
    cw = rng.standard_normal((M, KS, D // M)).astype(np.float32)
    q = rng.standard_normal((qn, D)).astype(np.float32)
    tj = np.asarray(P.build_dtable(jnp.asarray(q), jnp.asarray(cw)).astype(jnp.float32))
    cw_t = torch.from_numpy(cw)
    tt = build_dtable(torch.from_numpy(q), cw_t, cw_norms=codeword_norms(cw_t))
    np.testing.assert_array_equal(tt.float().numpy(), tj)
