"""The row-major scans of the port (kernels H, I and J: hopper_scan,
hopper_i8 and hopper_pq) against rii_tpu.ops.pallas_scan's K11, K12 and K10
in Pallas interpret mode.

On the CPU the port's wrappers run the kernels' plain twins. N=3000 codes
(D=64, M=8, Ks=32) padded to cap=4096 by ``prepare_pq_scan_inputs``, so 8
tiles hold padding only; the rows of tile 2 are all one code, so every slot
there ties. Codewords and queries are below 0.1, so scores stay below 2 in
magnitude: there one step of the packed keys (2^-16 relative) lies inside
the stated 1e-5 + 1e-5*|s| tolerance.

Tolerances. Tile minima: values within 1e-5 relative + 1e-5 absolute (the
two sides sum the bf16 products in other orders); slots equal wherever the
two winning slots' scores differ by more than that, and on the all-tied
tile. Kernel I's minima are bit-equal (the int8 cross term is exact and the
score rounded once on both sides). Top-k: ids per rank, except where the
distance at that rank is tied within the tolerance (``torch.topk`` and
``lax.top_k`` order equal values differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rii_tpu.models.ivf import code_norms_np
from rii_tpu.ops import pallas_scan as P
from rii_tpu.ops.decode import build_decoded_cache
from rii_tpu_torch.ops import hopper_i8 as HI
from rii_tpu_torch.ops import hopper_pq as HP
from rii_tpu_torch.ops import hopper_scan as H

from _torch_parity import assert_ranked_ids_match

N, D, M, KS, BLK = 3000, 64, 8, 32, 1024
CAP = 4096
TIED_TILE = 2
TOL = 1e-5
# the JAX engine runs the int8 kernel under jit (XLA then multiplies by
# float32(1/127) in the query quantization); the JAX entry is jitted itself
_jax_i8_minima = jax.jit(P.replica_i8_scan_tile_minima,
                         static_argnames=("blk", "interpret"))


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(11)
    cw = (rng.random((M, KS, D // M)) * 0.1).astype(np.float32)
    codes = rng.randint(0, KS, (N, M)).astype(np.uint8)
    codes[TIED_TILE * 128:(TIED_TILE + 1) * 128] = codes[TIED_TILE * 128]
    norms = code_norms_np(cw, codes)
    codes_j, nc_j, cwp_j = P.prepare_pq_scan_inputs(codes, norms, cw, cap=CAP,
                                                     blk=BLK)
    dec_j = build_decoded_cache(codes_j, jnp.asarray(cw))
    dq_j, sc_j = P.quantize_replica_i8(dec_j)
    codes_t, nc_t, cwp_t = HP.prepare_pq_scan_inputs(codes, norms, cw, cap=CAP,
                                                     blk=BLK, device="cpu")
    dq_t, sc_t = HI.quantize_replica_i8(codes_t, torch.from_numpy(cw))
    return dict(rng=rng, cw=cw, codes=codes, norms=norms, codes_j=codes_j,
                nc_j=nc_j, cwp_j=cwp_j, dec_j=dec_j, dq_j=dq_j, sc_j=sc_j,
                codes_t=codes_t, nc_t=nc_t, cwp_t=cwp_t,
                dec_t=torch.from_numpy(np.array(dec_j.astype(jnp.float32)))
                .to(torch.bfloat16),
                dq_t=dq_t, sc_t=sc_t)


def _queries(data, qn):
    return (data["rng"].random((qn, D)) * 0.1).astype(np.float32)


def _scores64(data, q):
    """float64 scores (Q, CAP) of the bf16 decode against bf16 queries:
    what both sides round, used to tell a tie from a disagreement."""
    q16 = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    dec = data["dec_t"].double().numpy()
    return data["nc_t"].double().numpy()[:, 0][None, :] - 2.0 * q16 @ dec.T


def _assert_minima_match(v_t, a_t, v_j, a_j, scores=None):
    """Values within TOL; slots equal, or tied: the two slots' reference
    scores within TOL of each other. The all-tied tile agrees exactly."""
    v_t, a_t = v_t.numpy(), a_t.numpy()
    v_j, a_j = np.asarray(v_j), np.asarray(a_j)
    assert v_t.shape == v_j.shape == (v_j.shape[0], CAP // 128)
    fin = np.isfinite(v_j)
    np.testing.assert_array_equal(np.isfinite(v_t), fin)
    np.testing.assert_allclose(v_t[fin], v_j[fin], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(a_t[~fin], a_j[~fin])
    np.testing.assert_array_equal(a_t[:, TIED_TILE], a_j[:, TIED_TILE])
    qi, ti = np.nonzero(a_t != a_j)
    if scores is None:
        assert qi.size == 0
        return
    s_t, s_j = scores[qi, a_t[qi, ti]], scores[qi, a_j[qi, ti]]
    np.testing.assert_allclose(s_t, s_j, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
@pytest.mark.parametrize("qn", [8, 64])
def test_replica_scan_tile_minima_match_k11(data, packed, qn):
    q = _queries(data, qn)
    v_j, a_j = P.replica_scan_tile_minima(jnp.asarray(q), data["dec_j"],
                                          data["nc_j"], blk=BLK,
                                          interpret=True, packed=packed)
    v_t, a_t = H.replica_scan_tile_minima(torch.from_numpy(q), data["dec_t"],
                                          data["nc_t"], blk=BLK, packed=packed)
    _assert_minima_match(v_t, a_t, v_j, a_j, _scores64(data, q))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
@pytest.mark.parametrize("qn", [8, 64])
def test_pq_scan_tile_minima_match_k10(data, packed, qn):
    q = _queries(data, qn)
    v_j, a_j = P.pq_scan_tile_minima(jnp.asarray(q), data["codes_j"],
                                     data["nc_j"], data["cwp_j"], blk=BLK,
                                     interpret=True, packed=packed)
    v_t, a_t = HP.pq_scan_tile_minima(torch.from_numpy(q), data["codes_t"],
                                      data["nc_t"], data["cwp_t"], blk=BLK,
                                      packed=packed)
    _assert_minima_match(v_t, a_t, v_j, a_j, _scores64(data, q))


@pytest.mark.parametrize("qn", [8, 64])
def test_replica_i8_scan_tile_minima_bit_equal_k12(data, qn):
    """Reached: vmin and amin bit for bit (so the tied tile too)."""
    q = _queries(data, qn)
    v_j, a_j = _jax_i8_minima(jnp.asarray(q), data["dq_j"], data["sc_j"],
                              data["nc_j"], blk=BLK, interpret=True)
    v_t, a_t = HI.replica_i8_scan_tile_minima(torch.from_numpy(q), data["dq_t"],
                                              data["sc_t"], data["nc_t"],
                                              blk=BLK)
    _assert_minima_match(v_t, a_t, v_j, a_j)
    np.testing.assert_array_equal(v_t.numpy().view(np.int32),
                                  np.asarray(v_j).view(np.int32))


def test_quantized_rowmajor_replica_equals_jax(data):
    np.testing.assert_array_equal(data["dq_t"].numpy(), np.asarray(data["dq_j"]))
    np.testing.assert_array_equal(data["sc_t"].numpy(), np.asarray(data["sc_j"]))


def test_prepare_pq_scan_inputs_equal_jax(data):
    np.testing.assert_array_equal(data["codes_t"].numpy(),
                                  np.asarray(data["codes_j"]))
    np.testing.assert_array_equal(data["nc_t"].numpy(), np.asarray(data["nc_j"]))
    assert data["cwp_t"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        data["cwp_t"].float().numpy(),
        np.asarray(P.build_padded_codewords(data["cw"]).astype(jnp.float32)))
    cwp = HP.build_padded_codewords(data["cw"], device="cpu")
    assert torch.equal(cwp, data["cwp_t"])
    c2, n2, _ = HP.prepare_pq_scan_inputs(data["codes"][:100], data["norms"][:100],
                                          data["cw"], cap=2048, device="cpu")
    assert c2.shape == (2048, M) and (c2[100:] == 0).all()
    assert torch.isinf(n2[100:]).all() and n2.shape == (2048, 1)


def _topk_pair(data, qn, port, jax_fn, topk=10, rtol=TOL):
    q = _queries(data, qn)
    d_j, i_j = jax_fn(jnp.asarray(q))
    d_t, i_t = port(torch.from_numpy(q))
    assert i_t.dtype == torch.int64 and d_t.shape == (qn, topk)
    assert_ranked_ids_match(i_t.numpy(), d_t.numpy(), np.asarray(i_j),
                            np.asarray(d_j), rtol=rtol)
    return i_t.numpy()


@pytest.mark.parametrize("rescore", [True, False], ids=["rescored", "selection"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
def test_replica_scan_topk_matches_k11(data, rescore, packed):
    """recall_target=None on the JAX side (its approx_max_k is not exact on
    the CPU); packed picks the tile reduce on both sides. Rescored
    distances are exact ADC; selection-only ones carry the key's
    precision."""
    kw = dict(codes=data["codes_j"], codewords=jnp.asarray(data["cw"])) if rescore else {}
    kw_t = dict(codes=data["codes_t"], codewords=torch.from_numpy(data["cw"])) \
        if rescore else {}
    _topk_pair(
        data, 16,
        lambda q: H.replica_scan_topk(q, data["dec_t"], data["nc_t"], 10,
                                      blk=BLK, packed=packed, **kw_t),
        lambda q: P.replica_scan_topk(q, data["dec_j"], data["nc_j"], 10,
                                      blk=BLK, interpret=True,
                                      recall_target=None, packed=packed, **kw),
        rtol=TOL if rescore else 1e-4)


def test_replica_scan_topk_packed_default_follows_recall_target(data):
    q = torch.from_numpy(_queries(data, 4))
    args = (q, data["dec_t"], data["nc_t"], 10)
    d_p, i_p = H.replica_scan_topk(*args, packed=True)
    d_r, i_r = H.replica_scan_topk(*args, recall_target=0.99)
    d_e, i_e = H.replica_scan_topk(*args, packed=False)
    d_n, i_n = H.replica_scan_topk(*args, recall_target=None)
    assert torch.equal(d_p, d_r) and torch.equal(i_p, i_r)
    assert torch.equal(d_e, d_n) and torch.equal(i_e, i_n)


def test_replica_i8_scan_topk_matches_k12(data):
    """Always rescored: exact-ADC distances, ids per rank (ties aside)."""
    cw = torch.from_numpy(data["cw"])
    _topk_pair(
        data, 16,
        lambda q: HI.replica_i8_scan_topk(q, data["dq_t"], data["sc_t"],
                                          data["nc_t"], data["codes_t"], cw, 10,
                                          blk=BLK),
        lambda q: P.replica_i8_scan_topk(q, data["dq_j"], data["sc_j"],
                                         data["nc_j"], data["codes_j"],
                                         jnp.asarray(data["cw"]), 10, blk=BLK,
                                         interpret=True, recall_target=None))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
def test_pq_scan_topk_matches_k10(data, packed):
    """The default (recall_target=None) is the exact reduce on both sides;
    the packed reduce is JAX's tile minima merged by lax.top_k."""
    def jax_fn(q):
        if not packed:
            return P.pq_scan_topk(q, data["codes_j"], data["nc_j"],
                                  data["cwp_j"], 10, blk=BLK, interpret=True)
        v, a = P.pq_scan_tile_minima(q, data["codes_j"], data["nc_j"],
                                     data["cwp_j"], blk=BLK, interpret=True,
                                     packed=True)
        return P._merge_tile_minima(q, v, a, 10, None)

    _topk_pair(
        data, 16,
        lambda q: HP.pq_scan_topk(q, data["codes_t"], data["nc_t"],
                                  data["cwp_t"], 10, blk=BLK,
                                  recall_target=0.99 if packed else None),
        jax_fn, rtol=1e-4)


def test_masked_subset_via_norms(data):
    """A subset rides as +inf norms: only its ids come back."""
    keep = np.zeros(CAP, bool)
    keep[data["rng"].choice(N, 1500, replace=False)] = True
    nc = torch.where(torch.from_numpy(keep)[:, None], data["nc_t"],
                     torch.tensor(float("inf")))
    q = torch.from_numpy(_queries(data, 8))
    for d, i in (H.replica_scan_topk(q, data["dec_t"], nc, 10),
                 HP.pq_scan_topk(q, data["codes_t"], nc, data["cwp_t"], 10),
                 HI.replica_i8_scan_topk(q, data["dq_t"], data["sc_t"], nc,
                                         data["codes_t"],
                                         torch.from_numpy(data["cw"]), 10)):
        assert keep[i.numpy()].all() and torch.isfinite(d).all()


def test_padding_only_tiles_report_their_first_slot(data):
    """A tile of +inf norms: vmin +inf and amin its first slot, in both
    reduces (as JAX); top-k past the finite slots pads with -1 / +inf."""
    q = torch.from_numpy(_queries(data, 2))
    for packed in (True, False):
        v, a = H.replica_scan_tile_minima(q, data["dec_t"], data["nc_t"],
                                          packed=packed)
        last = torch.arange(CAP // 128 - 8, CAP // 128, dtype=torch.int32) * 128
        assert torch.isinf(v[:, -8:]).all() and (a[:, -8:] == last).all()
    nm = torch.full((CAP, 1), float("inf"))
    nm[:3] = data["nc_t"][:3]
    d, i = HP.pq_scan_topk(q, data["codes_t"], nm, data["cwp_t"], 4)
    assert (i[:, 0] >= 0).all() and (i[:, 1:] == -1).all()
    assert torch.isinf(d[:, 1:]).all()


def test_cpu_twins_launch_nothing(data):
    q = torch.from_numpy(_queries(data, 2))
    fns = (H.replica_scan_tile_minima, HI.replica_i8_scan_tile_minima,
           HP.pq_scan_tile_minima)
    before = [f.launches for f in fns]
    H.replica_scan_tile_minima(q, data["dec_t"], data["nc_t"])
    HI.replica_i8_scan_tile_minima(q, data["dq_t"], data["sc_t"], data["nc_t"])
    HP.pq_scan_tile_minima(q, data["codes_t"], data["nc_t"], data["cwp_t"])
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("m,ds", [(5, 4), (8, 8), (32, 4)])
def test_kernel_j_codebook_gather_equals_twin_stack(m, ds):
    """The codebook kernel J's wrapper gathers in one op equals the twin's
    per-sub-space stack, bit for bit."""
    cw = np.random.default_rng(m).random((m, 16, ds), dtype=np.float32)
    cwp = HP.build_padded_codewords(cw, device="cpu")
    got = HP._gathered_codebook(cwp, m)
    assert got.dtype == torch.bfloat16 and got.shape == (m, 16, ds)
    assert torch.equal(got, HP._compact_codebook(cwp, m))
    assert torch.equal(got, torch.from_numpy(cw).to(torch.bfloat16))


@pytest.mark.parametrize("blk", [512 + 256, 128, 8192])
def test_wrappers_keep_jax_block_rules(data, blk):
    """blk % 256, blk >= 1024 and cap % blk, as the JAX entries assert."""
    q = torch.from_numpy(_queries(data, 2))
    with pytest.raises(ValueError):
        H.replica_scan_tile_minima(q, data["dec_t"], data["nc_t"], blk=blk)
    with pytest.raises(ValueError):
        HP.pq_scan_tile_minima(q, data["codes_t"], data["nc_t"], data["cwp_t"],
                               blk=blk)
    with pytest.raises(ValueError):
        HI.replica_i8_scan_tile_minima(q, data["dq_t"], data["sc_t"],
                                       data["nc_t"], blk=blk)


def test_micro_scan_runs_on_the_cpu(capsys):
    """The ops-level micro benchmark at a rehearsal size, on the kernels'
    twins: every entry finds the row each query was drawn near, and the
    command line prints one JSON line per entry."""
    from rii_tpu_torch.benchmarks import micro_scan
    codes, cw, _ = micro_scan.make_data(nlog=12, m=M, d=D, ks=KS)
    near = np.array([5, 700, 2048, 4000])
    q = (cw[np.arange(M)[None, :], codes[near].astype(np.int64)].reshape(4, D)
         + np.random.RandomState(2).normal(0, 1e-3, (4, D))).astype(np.float32)
    recs = micro_scan.run("cpu", codes, cw, q, qns=(4,), reps=1)
    assert [r["op"] for r in recs] == list(micro_scan.KERNELS)
    for r in recs:
        assert r["timer"] == "host_clock" and r["ids"].shape == (4, 10)
        np.testing.assert_array_equal(r["ids"][:, 0], near)
    micro_scan.main(["--device", "cpu", "--nlog", "10", "--q", "4", "--m", "8",
                     "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(micro_scan.KERNELS)
    assert all('"device": "cpu"' in ln for ln in lines)


def test_wrappers_reject_bad_shapes(data):
    q = torch.from_numpy(_queries(data, 2))
    with pytest.raises(ValueError):
        H.replica_scan_tile_minima(torch.zeros((2, D + 1)), data["dec_t"],
                                   data["nc_t"])
    with pytest.raises(ValueError):  # norms as a flat vector, not (cap, 1)
        H.replica_scan_tile_minima(q, data["dec_t"], data["nc_t"][:, 0])
    with pytest.raises(ValueError):
        HP.pq_scan_tile_minima(q, data["codes_t"][:, :4], data["nc_t"],
                               data["cwp_t"])


def test_kernel_h_wrapper_rules(data):
    """Kernel H's replica: contiguous bf16 rows and contiguous float32
    norms, on both devices, any D; rows need no alignment (the kernel loads
    unaligned rows itself), and such rows give the aligned result."""
    q = torch.from_numpy(_queries(data, 2))
    dec, nc = data["dec_t"], data["nc_t"]
    for bad in (dec.T.contiguous().T, dec.float()):
        with pytest.raises(ValueError):
            H.replica_scan_tile_minima(q, bad, nc)
    with pytest.raises(ValueError):
        H.replica_scan_tile_minima(q, dec, nc.double())
    buf = torch.zeros(CAP * D + 1, dtype=torch.bfloat16)
    shifted = buf[1:].view(CAP, D)
    shifted.copy_(dec)
    assert shifted.data_ptr() % 16 != 0
    v, a = H.replica_scan_tile_minima(q, shifted, nc)
    v0, a0 = H.replica_scan_tile_minima(q, dec, nc)
    assert torch.equal(v, v0) and torch.equal(a, a0)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
def test_wide_rows_take_kernel_h(packed):
    """Rows wider than 512 (D = 520, whose queries the kernel streams
    through its ring) give rii_tpu's K11 tile minima within TOL, slots
    equal or tied within TOL in float64, as at D = 64."""
    rng = np.random.RandomState(520)
    cap, d = 1024, 520
    dec16 = torch.from_numpy((rng.random((cap, d)) * 0.1).astype(np.float32)).to(torch.bfloat16)
    nc = (dec16.float() ** 2).sum(1, keepdim=True)
    q = (rng.random((4, d)) * 0.1).astype(np.float32)
    v, a = H.replica_scan_tile_minima(torch.from_numpy(q), dec16, nc,
                                      packed=packed)
    vj, aj = P.replica_scan_tile_minima(
        jnp.asarray(q), jnp.asarray(dec16.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(nc.numpy()), blk=BLK, interpret=True, packed=packed)
    vj, aj = np.asarray(vj), np.asarray(aj)
    np.testing.assert_allclose(v.numpy(), vj, rtol=TOL, atol=TOL)
    s64 = (nc.double().numpy()[:, 0][None, :] - 2.0 * torch.from_numpy(q)
           .to(torch.bfloat16).double().numpy() @ dec16.double().numpy().T)
    qi, ti = np.nonzero(a.numpy() != aj)
    np.testing.assert_allclose(s64[qi, a.numpy()[qi, ti]], s64[qi, aj[qi, ti]],
                               rtol=TOL, atol=TOL)
