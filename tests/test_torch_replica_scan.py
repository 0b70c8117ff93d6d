"""Kernel A's module (rii_tpu_torch.ops.hopper_scan, replica scan) against
rii_tpu.ops.pallas_scan in Pallas interpret mode.

On the CPU the port's wrapper runs kernel A's plain twin. Inputs are scaled
so that scores stay below 2 in magnitude: there one step of the packed keys
(2^-16 relative) lies inside the stated 1e-5 + 1e-5*|s| tolerance, and the
two sides, which sum in different orders, may land one step apart."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rii_tpu.models.ivf import code_norms_np
from rii_tpu.ops import pallas_scan as P
from rii_tpu_torch.ops import hopper_scan as H

from _torch_parity import assert_keys_match, assert_ranked_ids_match, unpack

D, CAP, M, KS = 64, 4096, 8, 32


@pytest.fixture(scope="module")
def replica():
    """Codes, codewords (values below 0.1), the bf16 replica and norms with
    +inf on the 96 padding slots."""
    rng = np.random.RandomState(3)
    cw = (rng.random((M, KS, D // M)) * 0.1).astype(np.float32)
    codes = rng.randint(0, KS, (CAP, M)).astype(np.uint8)
    dec = cw[np.arange(M)[None, :], codes.astype(np.int64)].reshape(CAP, D)
    dec16 = jnp.asarray(dec, jnp.bfloat16)
    norms = code_norms_np(cw, codes)
    norms[-96:] = np.inf
    dec_t = np.asarray(dec16.T.astype(jnp.float32))
    return {"cw": cw, "codes": codes, "dec16": dec16, "norms": norms,
            "dec_t": torch.from_numpy(dec_t.copy()).to(torch.bfloat16),
            "rng": rng}


def _queries(rng, qn):
    return (rng.random((qn, D)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("qn,jax_keys", [(8, P._replica_keys_nn),
                                         (512, P._replica_keys_tn)])
def test_tile_keys_match_pallas(replica, qn, jax_keys):
    """Q=8 takes K1's route in rii_tpu, Q=512 K2's; kernel A serves both."""
    q = _queries(replica["rng"], qn)
    dt, nr = P.prepare_replica_t(replica["dec16"], jnp.asarray(replica["norms"]))
    kj = np.asarray(jax_keys(jnp.asarray(q), dt, nr, interpret=True))
    kt = H.replica_tile_keys(torch.from_numpy(q), replica["dec_t"],
                             torch.from_numpy(replica["norms"])).numpy()
    assert kt.shape == (qn, CAP // 128)
    assert np.abs(kt).max() < 2.0  # see the module docstring
    assert_keys_match(*unpack(kt, 0x7F), *unpack(kj, 0x7F))


@pytest.mark.parametrize("qn", [8, 512])
def test_rescored_topk_matches_pallas(replica, qn):
    """Overfetch + exact float32 rescore: ids per rank (ties aside)."""
    q = _queries(replica["rng"], qn)
    dt, nr = P.prepare_replica_t(replica["dec16"], jnp.asarray(replica["norms"]))
    dj, ij = P.replica_scan_topk_t(jnp.asarray(q), dt, nr, topk=5,
                                   codes=jnp.asarray(replica["codes"]),
                                   codewords=jnp.asarray(replica["cw"]),
                                   recall_target=None, interpret=True)
    dt_t, nr_t = H.prepare_replica_t(replica["dec_t"].T,
                                     torch.from_numpy(replica["norms"]))
    d, i = H.replica_scan_topk_t(torch.from_numpy(q), dt_t, nr_t, topk=5,
                                 codes=torch.from_numpy(replica["codes"]),
                                 codewords=torch.from_numpy(replica["cw"]))
    assert_ranked_ids_match(i.numpy(), d.numpy(), np.asarray(ij),
                            np.asarray(dj), rtol=1e-5)


def test_selection_only_matches_pallas(replica):
    """Without codes the merge over packed keys returns key-precision
    distances: equal ids, values to the packing step."""
    q = _queries(replica["rng"], 8)
    dt, nr = P.prepare_replica_t(replica["dec16"], jnp.asarray(replica["norms"]))
    dj, ij = P.replica_scan_topk_t(jnp.asarray(q), dt, nr, topk=5,
                                   recall_target=None, interpret=True)
    d, i = H.replica_scan_topk_t(torch.from_numpy(q), replica["dec_t"],
                                 torch.from_numpy(replica["norms"])[None, :],
                                 topk=5)
    assert_ranked_ids_match(i.numpy(), d.numpy(), np.asarray(ij),
                            np.asarray(dj), rtol=1e-4)


def test_masked_subset_via_norms(replica):
    """A subset rides as +inf norms: only its ids come back, as in JAX."""
    rng = replica["rng"]
    q = _queries(rng, 8)
    keep = np.zeros(CAP, bool)
    keep[rng.choice(CAP - 96, 1500, replace=False)] = True
    nm = np.where(keep, replica["norms"], np.inf).astype(np.float32)
    dt, _ = P.prepare_replica_t(replica["dec16"], jnp.asarray(nm))
    dj, ij = P.replica_scan_topk_t(jnp.asarray(q), dt, jnp.asarray(nm[None]),
                                   topk=5, codes=jnp.asarray(replica["codes"]),
                                   codewords=jnp.asarray(replica["cw"]),
                                   recall_target=None, interpret=True)
    d, i = H.replica_scan_topk_t(torch.from_numpy(q), replica["dec_t"],
                                 torch.from_numpy(nm)[None, :], topk=5,
                                 codes=torch.from_numpy(replica["codes"]),
                                 codewords=torch.from_numpy(replica["cw"]))
    assert keep[i.numpy()].all()
    assert_ranked_ids_match(i.numpy(), d.numpy(), np.asarray(ij),
                            np.asarray(dj), rtol=1e-5)


def test_padding_only_tiles_return_minus_one(replica):
    """More candidates asked than finite slots: padded with -1 / +inf."""
    nm = np.full(CAP, np.inf, np.float32)
    nm[:3] = replica["norms"][:3]
    d, i = H.replica_scan_topk_t(torch.zeros((2, D)), replica["dec_t"],
                                 torch.from_numpy(nm)[None, :], topk=4)
    assert (i[:, 0] >= 0).all() and (i[:, 1:] == -1).all()
    assert torch.isinf(d[:, 1:]).all()


def test_cpu_twin_launches_nothing(replica):
    before = H.replica_tile_keys.launches
    H.replica_tile_keys(torch.zeros((2, D)), replica["dec_t"],
                        torch.from_numpy(replica["norms"]))
    assert H.replica_tile_keys.launches == before


def test_wrapper_rejects_bad_shapes(replica):
    with pytest.raises(ValueError):
        H.replica_tile_keys(torch.zeros((2, D + 1)), replica["dec_t"],
                            torch.from_numpy(replica["norms"]))
    with pytest.raises(ValueError):
        H.replica_tile_keys(torch.zeros((2, D)), replica["dec_t"][:, :100],
                            torch.from_numpy(replica["norms"][:100]))


def test_wrapper_rejects_what_the_kernel_cannot_read(replica):
    """The rules of kernel A's replica hold on both devices: contiguous,
    16-byte aligned bf16 (its tiles are TMA copies) and contiguous float32
    norms. Any D is taken."""
    q = torch.zeros((2, D))
    norms = torch.from_numpy(replica["norms"])
    dec_t = replica["dec_t"]
    buf = torch.zeros(D * CAP + 1, dtype=torch.bfloat16)
    misaligned = buf[1:].view(D, CAP)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16 != 0
    cases = [
        (q, misaligned, norms),
        (q, dec_t.T.contiguous().T, norms),  # non-contiguous (D, cap)
        (q, dec_t.float(), norms),
        (q, dec_t, norms.double()),
        (q, dec_t, torch.stack([norms, norms], 1)[:, 0]),  # strided norms
    ]
    for args in cases:
        with pytest.raises(ValueError):
            H.replica_tile_keys(*args)
    H.replica_tile_keys(q, dec_t, norms)  # the same inputs, well formed


@pytest.mark.parametrize("d", [70, 520, 960])
def test_wide_rows_take_kernel_a(d):
    """Rows wider than 512 (whose queries the kernel streams through its
    ring) are taken as any other D, and give the twin's keys."""
    rng = np.random.RandomState(d)
    dec_t = torch.from_numpy(rng.random((d, 256)).astype(np.float32) * 0.1).to(torch.bfloat16)
    norms = (dec_t.float() ** 2).sum(0)
    q = torch.from_numpy(rng.random((3, d)).astype(np.float32) * 0.1)
    assert torch.equal(H.replica_tile_keys(q, dec_t, norms),
                       H.replica_tile_keys_plain(q, dec_t, norms))


@pytest.mark.parametrize("d,offset", [(64, 0), (64, 1), (70, 0), (960, 3)])
def test_kernel_queries_are_tma_rows(d, offset):
    """The queries handed to kernels A and H: bf16 rows of a multiple of 8
    elements, zero past D, from a 16-byte aligned base, equal to the
    queries cast to bf16 (a view of the input where it already is so)."""
    buf = torch.from_numpy(np.random.RandomState(d).random(5 * d + offset).astype(np.float32))
    src = buf[offset:].view(5, d).to(torch.bfloat16)
    q16, ldq = H._tc_queries(src)
    assert ldq % 8 == 0 and d <= ldq < d + 8 and q16.shape == (5, ldq)
    assert q16.dtype == torch.bfloat16 and q16.is_contiguous()
    assert q16.data_ptr() % 16 == 0
    assert torch.equal(q16[:, :d], src) and not q16[:, d:].any()
    if ldq == d and src.data_ptr() % 16 == 0:
        assert q16.data_ptr() == src.data_ptr()
