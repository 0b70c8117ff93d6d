"""Kernel F's module (rii_tpu_torch.ops.hopper_i8: the int8 quantization and
the int8 replica scan) against rii_tpu.ops.pallas_scan in Pallas interpret
mode.

On the CPU the port's wrapper runs kernel F's plain twin. The port keeps
the int8 replica row-major, (cap, D); the JAX package's K4/K5 read it
transposed, so the Pallas side is fed the transpose of the same rows. The
quantized replica, its scales and the quantized queries must equal the JAX
package's bit for bit, and so must the packed keys (the int8 cross term is
exact and the score is rounded once on both sides); the tolerance stated
for the keys is the kernels' usual 1e-5 rel + 1e-5 abs. The JAX side runs
under jit, as the JAX engine runs it: there XLA turns the query
quantization's division by 127 into a product with its reciprocal."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rii_tpu.models.ivf import code_norms_np
from rii_tpu.ops import pallas_scan as P
from rii_tpu.ops.decode import build_decoded_cache
from rii_tpu_torch.ops import hopper_i8 as HI

from _torch_parity import assert_keys_match, assert_ranked_ids_match, unpack

CAP, KS, NPAD = 4096, 32, 96
_jax_keys = jax.jit(partial(P._replica_keys_i8t, interpret=True))
_jax_queries = jax.jit(P._quantize_queries_i8)


def _make(seed, d, m):
    """Codes with NPAD padding rows (code 0, as the engine pads), codewords
    below 0.1, JAX's quantized replica and the port's (both (cap, D) rows;
    the port's built in blocks of 1000 rows), norms +inf on the padding."""
    rng = np.random.RandomState(seed)
    cw = (rng.random((m, KS, d // m)) * 0.1).astype(np.float32)
    codes = rng.randint(0, KS, (CAP, m)).astype(np.uint8)
    codes[-NPAD:] = 0
    dec = build_decoded_cache(jnp.asarray(codes), jnp.asarray(cw))
    q_j, s_j = P.quantize_replica_i8(dec)
    r_t, s_t = HI.quantize_replica_i8(torch.from_numpy(codes),
                                      torch.from_numpy(cw), block=1000)
    norms = code_norms_np(cw, codes)
    norms[-NPAD:] = np.inf
    return dict(cw=cw, codes=codes, q_j=np.asarray(q_j), s_j=np.asarray(s_j),
                r_t=r_t, s_t=s_t, norms=norms, rng=rng, d=d)


@pytest.fixture(scope="module", params=[(64, 8), (30, 15)],
                ids=["D64", "D30"])
def rep(request):
    """D=64, and D=30, which is not a multiple of 16 (the kernel's loaded
    rows and zero-padded queries)."""
    return _make(3, *request.param)


def _queries(rep, qn):
    return (rep["rng"].random((qn, rep["d"])) * 0.1).astype(np.float32)


def test_quantized_replica_equals_jax_bit_for_bit(rep):
    """Scales over every row, padding included; blocks of 1000 rows give
    the one-shot result."""
    np.testing.assert_array_equal(rep["s_t"].numpy(), rep["s_j"])
    np.testing.assert_array_equal(rep["r_t"].numpy(), rep["q_j"])
    q_rows, s_rows = HI.quantize_replica_i8(torch.from_numpy(rep["codes"]),
                                            torch.from_numpy(rep["cw"]))
    np.testing.assert_array_equal(q_rows.numpy(), rep["q_j"])
    np.testing.assert_array_equal(s_rows.numpy(), rep["s_j"])


def test_quantized_queries_equal_jax_bit_for_bit(rep):
    q = _queries(rep, 700)
    q_j, a_j = _jax_queries(jnp.asarray(q), jnp.asarray(rep["s_j"]))
    q_t, a_t = HI.quantize_queries_i8(torch.from_numpy(q), rep["s_t"])
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))


def test_requantized_rows_equal_jax(rep):
    """Added rows are quantized with the existing scales, clipped (the JAX
    engine's growth formula), including values past the old maxima."""
    rows = (rep["rng"].standard_normal((50, rep["d"])) * 0.1).astype(np.float32)
    s = jnp.asarray(rep["s_j"])
    want = jnp.clip(jnp.round(jnp.asarray(rows) / s[None, :]), -127, 127)
    got = HI.quantize_rows_i8(torch.from_numpy(rows), rep["s_t"])
    assert (np.abs(np.asarray(want)) == 127).any()  # clipping is exercised
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int8))


@pytest.mark.parametrize("qn", [8, 512])  # K4's route (Q<512), K5's (Q>=512)
def test_tile_keys_match_pallas(rep, qn):
    """The twin on the rows against the Pallas kernels on JAX's transposed
    replica (decoded_i8_t): keys bit-equal."""
    q = _queries(rep, qn)
    kj = np.asarray(_jax_keys(jnp.asarray(q), jnp.asarray(rep["q_j"]).T,
                              jnp.asarray(rep["s_j"]),
                              jnp.asarray(rep["norms"][None])))
    kt = HI.replica_i8_tile_keys(torch.from_numpy(q), rep["r_t"], rep["s_t"],
                                 torch.from_numpy(rep["norms"])).numpy()
    assert kt.shape == (qn, CAP // 128)
    assert_keys_match(*unpack(kt, 0x7F), *unpack(kj, 0x7F))
    np.testing.assert_array_equal(kt.view(np.int32), kj.view(np.int32))


def _topk_both(rep, q, norms, topk=5):
    dj, ij = P.replica_i8_scan_topk_t(
        jnp.asarray(q), jnp.asarray(rep["q_j"]).T, jnp.asarray(rep["s_j"]),
        jnp.asarray(norms[None]), jnp.asarray(rep["codes"]),
        jnp.asarray(rep["cw"]), topk=topk, recall_target=None, interpret=True)
    d, i = HI.replica_i8_scan_topk_t(
        torch.from_numpy(q), rep["r_t"], rep["s_t"],
        torch.from_numpy(norms)[None, :], torch.from_numpy(rep["codes"]),
        torch.from_numpy(rep["cw"]), topk)
    return d.numpy(), i.numpy(), np.asarray(dj), np.asarray(ij)


@pytest.mark.parametrize("qn", [8, 512])
def test_rescored_topk_matches_pallas(rep, qn):
    """Overfetch to max(2*topk, topk+8), then the exact float32 rescore:
    exact-ADC distances, ids per rank (ties aside)."""
    d, i, dj, ij = _topk_both(rep, _queries(rep, qn), rep["norms"])
    assert_ranked_ids_match(i, d, ij, dj, rtol=1e-5)


def test_masked_subset_via_norms(rep):
    """A subset rides as +inf norms: only its ids come back, as in JAX."""
    rng = rep["rng"]
    keep = np.zeros(CAP, bool)
    keep[rng.choice(CAP - NPAD, 1500, replace=False)] = True
    nm = np.where(keep, rep["norms"], np.inf).astype(np.float32)
    d, i, dj, ij = _topk_both(rep, _queries(rep, 8), nm)
    assert keep[i].all()
    assert_ranked_ids_match(i, d, ij, dj, rtol=1e-5)


def test_n_valid_past_the_data_changes_nothing(rep):
    """On the CPU n_valid is the kernel's promise only: keys with it equal
    keys without it, and tiles past the live rows hold the padding key."""
    q = torch.from_numpy(_queries(rep, 8))
    nm = rep["norms"].copy()
    nm[-256:] = np.inf  # the last two tiles hold padding only
    args = (q, rep["r_t"], rep["s_t"], torch.from_numpy(nm))
    k1 = HI.replica_i8_tile_keys(*args)
    k2 = HI.replica_i8_tile_keys(*args, n_valid=CAP - 256)
    assert torch.equal(k1, k2)
    v, lane = unpack(k1[:, -2:].numpy(), 0x7F)
    assert np.isinf(v).all() and (lane == 0).all()


def test_cpu_twin_launches_nothing(rep):
    before = HI.replica_i8_tile_keys.launches
    HI.replica_i8_tile_keys(torch.zeros((2, rep["d"])), rep["r_t"], rep["s_t"],
                            torch.from_numpy(rep["norms"]))
    assert HI.replica_i8_tile_keys.launches == before


def test_wrapper_rejects_bad_shapes(rep):
    d = rep["d"]
    with pytest.raises(ValueError):
        HI.replica_i8_tile_keys(torch.zeros((2, d + 1)), rep["r_t"], rep["s_t"],
                                torch.from_numpy(rep["norms"]))
    with pytest.raises(ValueError):  # cap not a multiple of the 128-slot tile
        HI.replica_i8_tile_keys(torch.zeros((2, d)), rep["r_t"][:100],
                                rep["s_t"], torch.from_numpy(rep["norms"][:100]))
    with pytest.raises(ValueError):  # the transposed replica is not taken
        HI.replica_i8_tile_keys(torch.zeros((2, d)), rep["r_t"].T.contiguous(),
                                rep["s_t"], torch.from_numpy(rep["norms"]))
    with pytest.raises(ValueError):  # rows must be int8 (the rules of the card)
        HI.replica_i8_tile_keys(torch.zeros((2, d)), rep["r_t"].int(),
                                rep["s_t"], torch.from_numpy(rep["norms"]))
