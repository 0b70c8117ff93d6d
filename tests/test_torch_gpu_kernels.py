"""The Hopper kernels against their plain twins, on the card.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is
False (a CUDA kernel has no CPU mode). On a machine with a card and nvcc:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_kernels.py

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine need not have; this file imports no JAX.) Shapes are small and
deliberately ragged (D not a multiple of 4, cap_v not a multiple of 32, Q not
a multiple of the kernels' query tile) to exercise the kernels' edges."""

import numpy as np
import pytest
import torch

from rii_tpu_torch.ops import hopper_i8 as HI
from rii_tpu_torch.ops import hopper_pq as HP
from rii_tpu_torch.ops import hopper_scan as H

from _torch_parity import assert_keys_match

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _np(*ts):
    return [t.cpu().numpy() for t in ts]


@pytest.mark.parametrize("qn,d", [(40, 70), (8, 128)])
def test_replica_tile_keys_matches_twin(cuda, qn, d):
    g = torch.Generator(device=cuda).manual_seed(qn)
    cap = 1 << 16
    dec_t = (torch.rand((d, cap), generator=g, device=cuda) * 0.08).to(torch.bfloat16)
    norms = (dec_t.float() ** 2).sum(0)
    norms[-300:] = float("inf")
    q = torch.rand((qn, d), generator=g, device=cuda) * 0.08
    before = H.replica_tile_keys.launches
    k = H.replica_tile_keys(q, dec_t, norms)
    torch.cuda.synchronize()
    assert H.replica_tile_keys.launches == before + 1
    t = H.replica_tile_keys_plain(q, dec_t, norms)
    v_k, l_k = H._unpack(k, 0x7F)
    v_t, l_t = H._unpack(t, 0x7F)
    assert_keys_match(*_np(v_k, l_k, v_t, l_t))


# The tensor-core kernel's edges (A and H): Q around its 64-row m-tile and
# past 128 (two m-tiles a warpgroup), D below one 64-dim chunk, ragged
# (70: H's loaded path), a multiple of 8 but not of 64 (72: H's TMA path)
# and whole chunks; one tile or three. Wider D and Q cover the other
# shared-memory configurations: up to D=512 the queries stay in shared
# memory, past it they stream through the ring (962 and 1700 ragged: H's
# loaded path, zero-padded queries). Streamed, also with one tile only (cap
# 128), an odd number of tiles (3, 5), an odd number of 128-row query
# blocks (300, 520 rows) and four or eight (1000; 1024 at D=960, the GIST
# shape).
_TC_EDGES = ([(qn, d, cap) for qn in (1, 63, 65, 200) for d in (16, 70, 72, 128)
              for cap in (128, 384)]
             + [(300, 256, 384), (130, 200, 384), (70, 320, 384), (300, 512, 384)]
             + [(1, 520, 384), (200, 520, 128), (65, 960, 384), (300, 962, 384),
                (130, 1700, 384)]
             + [(300, 960, 384), (520, 640, 640), (1000, 576, 128), (1024, 960, 1280)])


def _tc_scale(d):
    """Input scale: 0.08 up to D=512, smaller past it so that the products
    sum to no more than at D=512 (float32 sums in another order then differ
    by no more than there, inside the tolerance with the key's 2^-16 step)."""
    return 0.08 * min(1.0, (512 / d) ** 0.5)


def _tc_replica(g, cap, d, cuda):
    """A (cap, d) bf16 replica and (cap,) norms: with three tiles, tile 1's
    norms are all +inf and tile 2's rows all equal (every slot ties); with
    one, its last 40 slots are +inf. Returns (rows, norms, tied slot)."""
    dec = (torch.rand((cap, d), generator=g, device=cuda) * _tc_scale(d)).to(torch.bfloat16)
    tied = None
    if cap >= 384:
        dec[256:384] = dec[256]
        tied = 256
    norms = (dec.float() ** 2).sum(1)
    if cap >= 384:
        # equal rows, equal norms: a float32 row sum may round differently
        # from row to row when the rows' alignment differs (D=962)
        norms[256:384] = norms[256]
        norms[128:256] = float("inf")
    else:
        norms[-40:] = float("inf")
    return dec, norms, tied


@pytest.mark.parametrize("qn,d,cap", _TC_EDGES)
def test_replica_tile_keys_edges(cuda, qn, d, cap):
    g = torch.Generator(device=cuda).manual_seed(qn * 1000 + d)
    dec, norms, tied = _tc_replica(g, cap, d, cuda)
    dec_t = dec.T.contiguous()
    q = torch.rand((qn, d), generator=g, device=cuda) * _tc_scale(d)
    before = H.replica_tile_keys.launches
    k = H.replica_tile_keys(q, dec_t, norms)
    torch.cuda.synchronize()
    assert H.replica_tile_keys.launches == before + 1
    t = H.replica_tile_keys_plain(q, dec_t, norms)
    v_k, l_k = H._unpack(k, 0x7F)
    v_t, l_t = H._unpack(t, 0x7F)
    assert_keys_match(*_np(v_k, l_k, v_t, l_t))
    pad = ~torch.isfinite(v_t)
    assert torch.equal(l_k[pad], l_t[pad])
    if tied is not None:  # the tied tile's key: its sign decides which lane wins
        assert torch.equal(l_k[:, 2], l_t[:, 2])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
@pytest.mark.parametrize("qn,d,cap", _TC_EDGES)
def test_replica_scan_tile_minima_edges(cuda, monkeypatch, qn, d, cap, packed):
    """Kernel H below the JAX entries' 1024-slot block rule (the kernel
    itself steps by 128 slots): the wrapper without its blk check."""
    monkeypatch.setattr(H, "_check_rowmajor", lambda cap, blk, norms_col: None)
    g = torch.Generator(device=cuda).manual_seed(qn * 1000 + d + 7)
    dec, norms, tied = _tc_replica(g, cap, d, cuda)
    norms = norms[:, None].contiguous()
    q = torch.rand((qn, d), generator=g, device=cuda) * _tc_scale(d)
    before = H.replica_scan_tile_minima.launches
    v_k, a_k = H.replica_scan_tile_minima(q, dec, norms, packed=packed)
    torch.cuda.synchronize()
    assert H.replica_scan_tile_minima.launches == before + 1
    v_t, a_t = H.replica_scan_tile_minima_plain(q, dec, norms, packed=packed)
    _assert_minima(v_k, a_k, v_t, a_t, None if packed else tied)
    if tied is not None:
        assert torch.equal(a_k[:, 2], a_t[:, 2])


def test_replica_scan_tile_minima_misaligned_rows(cuda):
    """D=128 rows whose base is not 16-byte aligned take the loaded path."""
    g = torch.Generator(device=cuda).manual_seed(5)
    cap, d = 1 << 12, 128
    buf = (torch.rand(cap * d + 1, generator=g, device=cuda) * 0.08).to(torch.bfloat16)
    dec = buf[1:].view(cap, d)
    assert dec.data_ptr() % 16 != 0
    norms = (dec.float() ** 2).sum(1, keepdim=True)
    q = torch.rand((100, d), generator=g, device=cuda) * 0.08
    for packed in (True, False):
        v_k, a_k = H.replica_scan_tile_minima(q, dec, norms, packed=packed)
        v_t, a_t = H.replica_scan_tile_minima_plain(q, dec, norms, packed=packed)
        _assert_minima(v_k, a_k, v_t, a_t)


# Kernel B (the tensor-core kernel over the windows' bf16 rows): the two
# cases it began with (Q=45; D=37 with cap_v=40 and pen, D=128 with
# cap_v=256); Q around the m64 query tile, where both consumer warpgroups
# share it (Q <= 64) or each takes its own (65, 127), and past one block's
# 128 rows (200); cap_v from 8 to 1024 (U * cap_v a multiple of 128 or
# not); D below a chunk and ragged (37: rows 2-byte aligned, element
# loads), ragged (100: 8-byte aligned rows, 4-byte loads), a whole chunk
# (128) and past the resident queries' 512 (960: streamed queries); every
# entry a duplicate over a ragged union (51 entries), with and without
# pen. A fifth of the rows in every case hold the 1e15 sentinel, as
# padding rows do.
_B_CASES = ([(45, 37, 40, True, ""), (45, 128, 256, False, "")]
            + [(qn, 128, 256, True, "") for qn in (1, 8, 33, 64, 65, 127, 200)]
            + [(33, 100, cap_v, False, "") for cap_v in (8, 24, 128, 256, 1024)]
            + [(qn, d, 128, True, "") for qn in (8, 65) for d in (37, 100, 128, 960)]
            + [(40, 128, 64, with_pen, "all dup u51") for with_pen in (True, False)]
            + [(200, 960, 1024, False, "")])


@pytest.mark.parametrize("qn,d,cap_v,with_pen,case", _B_CASES)
def test_ivf_window_matches_twin(cuda, qn, d, cap_v, with_pen, case):
    g = torch.Generator(device=cuda).manual_seed(qn * 7 + d + cap_v)
    nwin, u = 30, 51 if "u51" in case else 50
    scale = 0.08 * min(1.0, (128 / d) ** 0.5)
    dec = (torch.rand((nwin * cap_v, d), generator=g, device=cuda) * scale).to(torch.bfloat16)
    dec[torch.rand(nwin * cap_v, generator=g, device=cuda) < 0.2] = 1e15
    flat = torch.sort(torch.randint(0, nwin, (u,), generator=g, device=cuda,
                                    dtype=torch.int32)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda),
                     (flat[1:] == flat[:-1]).to(torch.int32)])
    if "all dup" in case:
        dup = torch.ones_like(dup)
    pen = None
    if with_pen:
        pen = torch.where(torch.rand(nwin * cap_v, generator=g, device=cuda) < 0.3,
                          float("inf"), 0.0).to(torch.float32)
    q = torch.rand((qn, d), generator=g, device=cuda) * scale
    before = H.ivf_window_tile_minima.launches
    v_k, a_k = H.ivf_window_tile_minima(q, dec, flat, dup, cap_v, pen=pen)
    torch.cuda.synchronize()
    assert H.ivf_window_tile_minima.launches == before + 1
    v_t, a_t = H.ivf_window_tile_minima_plain(q, dec, flat, dup, cap_v, pen=pen)
    if "all dup" in case:  # every score +inf; the slots still agree
        assert not torch.isfinite(v_k).any() and not torch.isfinite(v_t).any()
        assert torch.equal(a_k, a_t)
    else:
        assert_keys_match(*_np(v_k, a_k, v_t, a_t))
    cols = np.repeat(dup.cpu().numpy() != 0, 2 * cap_v // 8)
    assert (a_k.cpu().numpy()[:, cols] == 0).all()


# Kernel C (the tensor-core scan over codes decoded by its producer): Ds a
# multiple of 8 (16-byte codeword loads: 16 at M=8, the SIFT1B shape; 8 at
# D=72, not a multiple of 64) or not (3, 4: element by element); Ks 256 or
# 100; Q from 1 to past 128 (two m64 tiles a warpgroup) and 300; D past 512
# (M=40, Ds=16: queries streamed) with the codebook in shared memory (Ks=100)
# or read from device memory (Ks=256, 320 KB). n_valid cuts a tile ("cut"),
# is 0 (every key the padding key, no codes read), is cap, or leaves one
# tile ("one").
_PQ_EDGES = [(13, 8, 256, 16, "cut"), (129, 8, 256, 16, "cut"), (1, 8, 256, 16, "cut"),
             (8, 32, 256, 4, "cut"), (300, 32, 256, 4, "cut"), (40, 5, 100, 3, "cut"),
             (1, 5, 100, 3, "cut"), (129, 24, 256, 3, "cut"), (129, 9, 100, 8, "cut"),
             (13, 40, 100, 16, "cut"), (300, 40, 256, 16, "cut"), (1, 40, 256, 16, "cut"),
             (13, 8, 256, 16, "none"), (300, 8, 256, 16, "one"), (129, 8, 100, 16, "all")]


@pytest.mark.parametrize("qn,m,ks,ds,live", _PQ_EDGES)
def test_pq_tile_keys_matches_twin(cuda, qn, m, ks, ds, live):
    """Kernel C against its twin; the slots from n_valid on are padding
    (+inf norms) and their tiles' keys are written without reading codes."""
    g = torch.Generator(device=cuda).manual_seed(qn + m + ks + ds)
    cap = 1 << 15
    n_valid = {"cut": cap - 20000, "none": 0, "one": 100, "all": cap}[live]
    cw = torch.rand((m, ks, ds), generator=g, device=cuda) * (0.4 / ds)
    codes_t = torch.randint(0, ks, (m, cap), generator=g, device=cuda,
                            dtype=torch.uint8)
    cw16 = cw.to(torch.bfloat16).float()
    dec = cw16[torch.arange(m, device=cuda), codes_t.T.long()].reshape(cap, -1)
    norms = (dec * dec).sum(1)
    norms[n_valid:] = float("inf")
    d = m * ds
    q = torch.rand((qn, d), generator=g, device=cuda) * (0.1 * min(1.0, (512 / d) ** 0.5))
    before = HP.pq_tile_keys.launches
    k = HP.pq_tile_keys(q, codes_t, norms, cw, n_valid=n_valid)
    torch.cuda.synchronize()
    assert HP.pq_tile_keys.launches == before + 1
    t = HP.pq_tile_keys_plain(q, codes_t, norms, cw)
    v_k, l_k = H._unpack(k, 0x7F)
    v_t, l_t = H._unpack(t, 0x7F)
    if n_valid > 0:  # with none, every key is the padding key
        assert_keys_match(*_np(v_k, l_k, v_t, l_t))
    pad = ~torch.isfinite(v_t)
    assert torch.equal(k.view(torch.int32)[pad], t.view(torch.int32)[pad])


def test_pq_tile_keys_rejects_wide_codebooks(cuda):
    """Codes are uint8: Ks past 256 raises, on the card as on the CPU."""
    cw = torch.zeros((4, 300, 8), device=cuda)
    codes_t = torch.zeros((4, 128), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        HP.pq_tile_keys(torch.zeros((2, 32), device=cuda), codes_t,
                        torch.zeros(128, device=cuda), cw)


# Kernel D (the tensor-core kernel over the windows' row-major codes): cap_v
# from 8 to 1024 (U * cap_v a multiple of 128 or not: 50 * 40, 50 * 8, 51 *
# 24), Q up to 512, Ds a multiple of 8, of 4 only (8-byte halves) or 3;
# every entry a duplicate, every vlen 0; a codebook too large for shared
# memory (D=384, 196 KB: read through L1) and D past 512 (640: queries
# streamed through the ring, codebook through L1). Cases "m<M>" set M (8
# elsewhere): D % 8 == 4, where the last 16-byte unit's second half lies
# past D, at Ds=4 (M=25, codebook in shared memory; M=45, through L1) and
# Ds=12 (M=5 in shared memory; M=25 through L1). Kernel E (the scan that
# builds its ADC table in its launch) takes the same cases but Q=512 and
# D=640 (a table chunk of 80 sub-spaces does not fit in shared memory):
# 1, 2 or 4 query chunks a block (Q=8, 13, 20 and up), several query
# blocks (Q=70), cap_v with nt % 4 == 0 (16-byte stores) or not (8, 24,
# 40), M a multiple of 4 (word code loads) or not (5, 25, 45).
_W_SHAPES = [
    (33, 16, 8, True, ""), (70, 16, 128, False, ""), (20, 16, 1024, True, ""),
    (40, 4, 256, False, ""), (70, 16, 24, True, "u51"),
    (70, 16, 256, True, "all dup"), (70, 16, 256, False, "vlen 0"),
    (40, 48, 64, True, ""), (40, 4, 256, True, "m25"), (70, 4, 64, False, "m45"),
    (40, 12, 64, True, "m5"), (40, 12, 64, False, "m25")]
_W_CASES = [pytest.param(*c, "", id="-".join(map(str, c))) for c in (
    ("D", 70, 16, 256, True), ("D", 33, 3, 40, False),
    ("E", 8, 16, 256, True), ("E", 21, 3, 40, False))] + [
    ("D", *c) for c in _W_SHAPES[:3]] + [
    ("D", 512, 16, 256, True, "")] + [("D", *c) for c in _W_SHAPES[3:7]] + [
    ("D", 40, 48, 64, True, ""), ("D", 40, 80, 64, True, "")] + [
    ("D", *c) for c in _W_SHAPES[8:]] + [("E", *c) for c in _W_SHAPES] + [
    ("E", 13, 16, 256, False, ""), ("E", 1, 16, 256, True, ""), ("E", 127, 16, 256, True, "")]


@pytest.mark.parametrize("kernel,qn,ds,cap_v,with_pen,case", _W_CASES)
def test_ivf_pq_windows_match_twin(cuda, kernel, qn, ds, cap_v, with_pen, case):
    """Kernels D and E with duplicates, vlen padding and the pen stream;
    ragged Q, Ds and cap_v exercise the kernels' edges."""
    g = torch.Generator(device=cuda).manual_seed(qn)
    m = int(case[1:]) if case.startswith("m") else 8
    ks, nwin, u = 256, 30, 51 if case == "u51" else 50
    cw = torch.rand((m, ks, ds), generator=g, device=cuda) * (0.4 / ds)
    codes_g = torch.randint(0, ks, (nwin * cap_v, m), generator=g, device=cuda,
                            dtype=torch.uint8)
    vlen_w = torch.randint(0, cap_v + 1, (nwin,), generator=g, device=cuda,
                           dtype=torch.int32)
    flat = torch.sort(torch.randint(0, nwin, (u,), generator=g, device=cuda,
                                    dtype=torch.int32)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda),
                     (flat[1:] == flat[:-1]).to(torch.int32)])
    pen = None
    if with_pen:
        pen = torch.where(torch.rand(nwin * cap_v, generator=g, device=cuda) < 0.3,
                          float("inf"), 0.0).to(torch.float32)
    q = torch.rand((qn, m * ds), generator=g, device=cuda) * 0.1
    fn, twin = ((HP.ivf_pq_window_tile_minima, HP.ivf_pq_window_tile_minima_plain)
                if kernel == "D" else
                (HP.ivf_dt_window_tile_minima, HP.ivf_dt_window_tile_minima_plain))
    vl = vlen_w[flat.long()]
    if case == "all dup":
        dup = torch.ones_like(dup)
    elif case == "vlen 0":
        vl = torch.zeros_like(vl)
    before = fn.launches
    v_k, a_k = fn(q, codes_g, cw, flat, dup, vl, cap_v, pen=pen)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    v_t, a_t = twin(q, codes_g, cw, flat, dup, vl, cap_v, pen=pen)
    if case in ("all dup", "vlen 0"):  # every score +inf; the slots still agree
        assert not torch.isfinite(v_k).any() and not torch.isfinite(v_t).any()
        assert torch.equal(a_k, a_t)
    else:
        assert_keys_match(*_np(v_k, a_k, v_t, a_t))
    cols = np.repeat(dup.cpu().numpy() != 0, 2 * cap_v // 8)
    assert (a_k.cpu().numpy()[:, cols] == 0).all()


# Kernel D selecting in its epilogue (the entry's ``k``) against the
# selection the union made before over D's full output (ops/ivf.py's
# _select_tiles: the selection kernel and a gather of the slots), bit for
# bit: (qn, U, cap_v, windows, k, pen, case). Duplicate entries, windows
# past vlen and the pen stream give +inf candidates; "ties" repeats 17 code
# rows throughout, so scores tie exactly; "split" takes 4 entries of 32
# tiles each over a grid of one tile a slot group; "few" has 6 columns for
# k=64; "d640" D=640 (M=8, Ds=80), whose queries stream through the ring
# and whose products are summed in parts; "shard" the SIFT1B shard's call
# (Q=512, U * cap_v = 2^23).
_TOPK_CASES = [
    (70, 50, 256, 30, 20, True, ""), (33, 50, 40, 30, 64, False, ""),
    (130, 51, 24, 30, 1, True, ""), (40, 50, 256, 30, 20, False, "ties"),
    (40, 50, 256, 30, 33, True, "ties"), (40, 4, 4096, 8, 20, True, "split"),
    (20, 1, 24, 4, 64, False, "few"), (70, 50, 256, 30, 20, True, "all dup"),
    (70, 50, 256, 30, 32, False, "vlen 0"), (130, 50, 64, 30, 20, True, "d640"),
    (512, 2048, 4096, 4096, 20, False, "shard")]


def _pq_union(g, cuda, qn, u, cap_v, nwin, with_pen, case, m=8):
    """Kernel D's inputs: codes, codebook, a sorted union with duplicates,
    each entry's vlen, the pen stream and queries."""
    ks, ds = 256, 80 if case == "d640" else 16
    cw = torch.rand((m, ks, ds), generator=g, device=cuda) * (0.4 / ds)
    codes_g = torch.randint(0, ks, (nwin * cap_v, m), generator=g, device=cuda,
                            dtype=torch.uint8)
    if case == "ties":
        codes_g = codes_g[torch.arange(nwin * cap_v, device=cuda) % 17].contiguous()
    flat = torch.sort(torch.randint(0, nwin, (u,), generator=g, device=cuda,
                                    dtype=torch.int32)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda),
                     (flat[1:] == flat[:-1]).to(torch.int32)])
    vl = torch.randint(0, cap_v + 1, (nwin,), generator=g, device=cuda,
                       dtype=torch.int32)[flat.long()]
    if case == "all dup":
        dup = torch.ones_like(dup)
    elif case == "vlen 0":
        vl = torch.zeros_like(vl)
    pen = None
    if with_pen:
        pen = torch.where(torch.rand(nwin * cap_v, generator=g, device=cuda) < 0.3,
                          float("inf"), 0.0).to(torch.float32)
    q = torch.rand((qn, m * ds), generator=g, device=cuda) * 0.1
    return q, codes_g, cw, flat, dup, vl, pen


@pytest.mark.parametrize("qn,u,cap_v,nwin,k,with_pen,case", _TOPK_CASES)
def test_pq_window_topk_is_the_selection_of_its_minima(cuda, qn, u, cap_v, nwin, k,
                                                       with_pen, case):
    from rii_tpu_torch.ops.ivf import _select_tiles
    g = torch.Generator(device=cuda).manual_seed(qn * 7 + k)
    q, codes_g, cw, flat, dup, vl, pen = _pq_union(g, cuda, qn, u, cap_v, nwin,
                                                   with_pen, case)
    vmin, amin = HP.ivf_pq_window_tile_minima(q, codes_g, cw, flat, dup, vl, cap_v,
                                              pen=pen)
    want_v, want_s, _ = _select_tiles(vmin, amin, k)
    kk = min(k, vmin.shape[1])
    del vmin, amin
    before = HP.ivf_pq_window_tile_minima.launches
    got_v, got_s = HP.ivf_pq_window_tile_minima(q, codes_g, cw, flat, dup, vl, cap_v,
                                                pen=pen, k=k)
    torch.cuda.synchronize()
    assert HP.ivf_pq_window_tile_minima.launches == before + 1
    assert got_v.shape == got_s.shape == (qn, kk) and got_s.dtype == torch.int32
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_s, want_s)
    if case == "all dup":
        assert not torch.isfinite(got_v).any() and not got_s.any()
    if case == "ties":  # ties among the kept values: resolved by column
        v = got_v.cpu().numpy()
        assert (v[:, 1:] == v[:, :-1]).any()


def test_pq_window_topk_limits(cuda):
    """k past the epilogue's lists raises; the shape rule keeps the union off
    that path."""
    g = torch.Generator(device=cuda).manual_seed(5)
    args = _pq_union(g, cuda, 40, 50, 256, 30, False, "")
    q, codes_g, cw, flat, dup, vl, _ = args
    with pytest.raises(ValueError):
        HP.ivf_pq_window_tile_minima(q, codes_g, cw, flat, dup, vl, 256,
                                     k=HP.PQ_WINDOW_TOPK_MAX + 1)
    assert not HP.pq_window_selects(HP.PQ_WINDOW_TOPK_MAX + 1, 50, 256)


# Kernel D at a Q of each cluster size (hopper_pq.pq_window_cluster): one
# query block (64, 128), an even number in pairs (2, 4 and 8 blocks: 129,
# 512, 1024), an odd number, each alone (3, 5 and 9: 300, 640, 1100).
_CLUSTER_QS = [64, 128, 129, 300, 512, 640, 1024, 1100]


@pytest.mark.parametrize("out", ["top2", "topk"])
@pytest.mark.parametrize("qn", _CLUSTER_QS)
def test_pq_window_clusters_decode_each_tile_once(cuda, qn, out):
    """Both of D's outputs at Q past one query block equal, bit for bit,
    those of its 128-row blocks launched one by one (one block, no
    cluster); the full output agrees with the twin, the selection is the
    selection of the full output, and the call notes the tile decodes of
    the cluster size the entry reports (one where its blocks form a
    cluster)."""
    from torch.profiler import ProfilerActivity, profile

    from rii_tpu_torch.ops.ivf import _select_tiles
    from rii_tpu_torch.utils import profiling as prof
    g = torch.Generator(device=cuda).manual_seed(qn)
    q, codes_g, cw, flat, dup, vl, pen = _pq_union(g, cuda, qn, 200, 256, 60, True, "")
    k = 20 if out == "topk" else None

    def call(rows, kk=k):
        return HP.ivf_pq_window_tile_minima(rows, codes_g, cw, flat, dup, vl, 256, pen=pen,
                                            k=kk)

    with profile(activities=[ProfilerActivity.CPU]):
        root = prof.begin_call("test.window")
        got = call(q)
        prof.end_call(root)
    torch.cuda.synchronize()
    nqb = -(-qn // 128)
    decodes = [r for r in prof.spans() if r.id == root.id][0].attrs["tile_decodes"]
    assert decodes == nqb // HP.pq_window_cluster(qn, q.shape[1])
    assert decodes == (nqb // 2 if nqb % 2 == 0 else nqb)
    for b in range(nqb):
        alone = call(q[128 * b:128 * (b + 1)])
        for x, y in zip(got, alone):
            assert torch.equal(x[128 * b:128 * (b + 1)].view(torch.int32), y.view(torch.int32))
    if out == "top2":
        assert_keys_match(*_np(*got, *HP.ivf_pq_window_tile_minima_plain(
            q, codes_g, cw, flat, dup, vl, 256, pen=pen)))
    else:
        want_v, want_s, _ = _select_tiles(*call(q, None), k)
        assert torch.equal(got[0].view(torch.int32), want_v.view(torch.int32))
        assert torch.equal(got[1], want_s)


def test_pq_union_spy_sees_the_selecting_call(cuda):
    """The benchmark's spy on ops/ivf.py's name for kernel D (it counts the
    union's live rows for scan_roofline.pq) sees the call that selects in
    D's epilogue, and the union's answer equals the one over D's full output
    and the selection kernel."""
    from portbench.harness.trace import UnionSpy
    from rii_tpu_torch.ops import ivf as IV
    g = torch.Generator(device=cuda).manual_seed(9)
    m, ks, ds, cap_v, nwin, qn = 8, 256, 16, 256, 64, 128
    cw = torch.rand((m, ks, ds), generator=g, device=cuda) * (0.4 / ds)
    codes_g = torch.randint(0, ks, (nwin * cap_v, m), generator=g, device=cuda,
                            dtype=torch.uint8)
    vlen = torch.randint(1, cap_v + 1, (nwin,), generator=g, device=cuda,
                         dtype=torch.int32)
    live = torch.arange(cap_v, device=cuda)[None, :] < vlen[:, None]
    dec = cw[torch.arange(m, device=cuda), codes_g.long()].reshape(nwin * cap_v, -1)
    norms_g = torch.where(live.reshape(-1), (dec * dec).sum(1), float("inf"))
    order_g = torch.where(live.reshape(-1), torch.arange(nwin * cap_v, device=cuda),
                          -1).to(torch.int32)
    centers = torch.rand((nwin, m * ds), generator=g, device=cuda) * 0.1
    q = torch.rand((qn, m * ds), generator=g, device=cuda) * 0.1
    args = (q, codes_g, norms_g, order_g, cw, centers, (centers ** 2).sum(1))
    kw = dict(w=4, topk=10, cap_u=cap_v, nlist_pad=nwin, vlen=vlen, use_kernel=True)
    spy = UnionSpy()
    spy.install()
    try:
        before = HP.ivf_pq_window_tile_minima.launches
        d_f, i_f = IV.ivf_union_scan_topk_pq(*args, **kw)
        torch.cuda.synchronize()
    finally:
        spy.remove()
    assert HP.ivf_pq_window_tile_minima.launches == before + 1
    assert len(spy.records) == 1 and spy.rows()[0][1] == qn and spy.rows()[0][2] > 0
    select = IV.pq_window_selects
    IV.pq_window_selects = lambda *a: False
    try:
        d_s, i_s = IV.ivf_union_scan_topk_pq(*args, **kw)
    finally:
        IV.pq_window_selects = select
    assert torch.equal(d_f, d_s) and torch.equal(i_f, i_s)


# Kernel E's table: the M / Ds shapes of the pq tier's codecs (8/16 the
# SIFT1B shape, 32/4 the ops shape) and ragged ones (5/12, 21/3), over one,
# one chunk of 8, a ragged and several chunks of queries.
@pytest.mark.parametrize("qn", [1, 8, 13, 64, 127])
@pytest.mark.parametrize("m,ds", [(8, 16), (32, 4), (16, 8), (5, 12), (21, 3)])
def test_dt_table_is_build_dtable_bit_for_bit(cuda, m, ds, qn):
    """Kernel E's table-only entry against build_dtable on the card (the
    einsum's float32 cross term, the in-order norms, the bf16 rounding),
    with and without the cached codeword norms."""
    from rii_tpu_torch.ops.decode import build_dtable, codeword_norms
    g = torch.Generator(device=cuda).manual_seed(m * 1000 + ds * 10 + qn)
    ks = 256
    cw = torch.randn((m, ks, ds), generator=g, device=cuda)
    q = torch.randn((qn, m * ds), generator=g, device=cuda)
    want = build_dtable(q, cw)  # (M, Ks, Q) bf16
    nqc = -(-qn // 8)
    want = torch.nn.functional.pad(want, (0, nqc * 8 - qn))
    want = want.view(m, ks, nqc, 8).permute(2, 0, 1, 3)
    for cwn in (None, codeword_norms(cw)):
        got = HP.dt_table(q, cw, cw_norms=cwn)
        torch.cuda.synchronize()
        assert got.shape == (nqc, m, ks, 8)
        real = (torch.arange(nqc * 8, device=cuda) < qn).view(nqc, 1, 1, 8)
        diff = (got.view(torch.int16) != want.view(torch.int16)) & real
        assert not diff.any(), f"{int(diff.sum())} table entries differ"


def _cuda_kernels(fn, calls=5):
    """The CUDA kernel launches a call of fn() makes, as the CUDA runtime
    saw them in torch.profiler over ``calls`` calls (the card's own
    records can miss one of a few very short kernels), and the names of
    the kernels the card ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()  # built and loaded before the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = prof.events()
    launched = sum(ev.device_type == DeviceType.CPU and ev.name.startswith("cudaLaunchKernel")
                   for ev in evs)
    return launched / calls, {ev.name for ev in evs if ev.device_type == DeviceType.CUDA}


def test_window_wrappers_kernel_counts(cuda):
    """A call of kernel E's wrapper launches one CUDA kernel (its table built
    in the launch) and no other op on the card; kernel G's launches two:
    the queries' quantization and the scan."""
    g = torch.Generator(device=cuda).manual_seed(12)
    m, ks, ds, cap_v, nwin, u, qn = 8, 256, 16, 256, 30, 50, 40
    d = m * ds
    cw = torch.rand((m, ks, ds), generator=g, device=cuda) * (0.4 / ds)
    codes_g = torch.randint(0, ks, (nwin * cap_v, m), generator=g, device=cuda,
                            dtype=torch.uint8)
    flat = torch.sort(torch.randint(0, nwin, (u,), generator=g, device=cuda,
                                    dtype=torch.int32)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda),
                     (flat[1:] == flat[:-1]).to(torch.int32)])
    vl = torch.randint(0, cap_v + 1, (u,), generator=g, device=cuda, dtype=torch.int32)
    pen = torch.where(torch.rand(nwin * cap_v, generator=g, device=cuda) < 0.3,
                      float("inf"), 0.0).to(torch.float32)
    q = torch.rand((qn, d), generator=g, device=cuda) * 0.1
    cwn = (cw * cw).sum(-1)
    n, names = _cuda_kernels(lambda: HP.ivf_dt_window_tile_minima(
        q, codes_g, cw, flat, dup, vl, cap_v, pen=pen, cw_norms=cwn))
    assert n == 1 and all("ivf_dt_window_top2" in nm for nm in names), (n, names)
    rows, scales, _ = _i8_rows(g, nwin * cap_v, d, cuda)
    n, names = _cuda_kernels(lambda: HI.ivf_i8_window_tile_minima(
        q, rows, scales, flat, dup, vl, cap_v, pen=pen))
    assert n == 2 and all("quantize_queries" in nm or "tc_scan_kernel" in nm
                          for nm in names), (n, names)


def _i8_rows(g, n, d, cuda):
    """Random int8 rows, column scales below 0.1/127 and the dequantized
    rows' squared norms (below 1.3 at D=128)."""
    rows = torch.randint(-127, 128, (n, d), generator=g, device=cuda,
                         dtype=torch.int32).to(torch.int8)
    scales = torch.rand(d, generator=g, device=cuda) * (0.1 / 127) + 1e-5
    norms = ((rows.float() * scales) ** 2).sum(1)
    return rows, scales, norms


# Kernels F and I (the tensor-core kernel on int8 operands): Q around one
# and two m64 tiles a warpgroup (kMT 1 and 2 from Q > 128), D a whole chunk
# (128: TMA), a multiple of 16 below it (48: TMA, zero-filled past D) and
# ragged (70: loaded rows); D past the resident queries' 1024 (F at 1040:
# queries streamed through the ring; the twin's float32 sums stay exact up
# to there), and I's widest, 1024.
_I8_EDGES = [(qn, d) for qn in (8, 100, 128, 300) for d in (128, 70, 48)]


@pytest.mark.parametrize("qn,d", _I8_EDGES + [(8, 1040), (300, 1040)])
def test_replica_i8_tile_keys_matches_twin(cuda, qn, d):
    """Kernel F; the last 20000 slots are padding that n_valid skips, and
    n_valid cuts a tile. The cross term is exact, so the keys are
    bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(qn + d)
    cap = 1 << 16
    rows, scales, norms = _i8_rows(g, cap, d, cuda)
    norms[-20000:] = float("inf")
    assert (cap - 20000) % 128 != 0
    q = torch.rand((qn, d), generator=g, device=cuda) * 0.1
    before = HI.replica_i8_tile_keys.launches
    k = HI.replica_i8_tile_keys(q, rows, scales, norms, n_valid=cap - 20000)
    torch.cuda.synchronize()
    assert HI.replica_i8_tile_keys.launches == before + 1
    t = HI.replica_i8_tile_keys_plain(q, rows, scales, norms)
    v_k, l_k = H._unpack(k, 0x7F)
    v_t, l_t = H._unpack(t, 0x7F)
    assert_keys_match(*_np(v_k, l_k, v_t, l_t))
    assert torch.equal(k.view(torch.int32), t.view(torch.int32))


def test_replica_i8_tile_keys_unaligned_and_empty(cuda):
    """Kernel F over D=128 rows whose base is not 16-byte (nor 4-byte)
    aligned, which takes the loaded path; and n_valid = 0, where every key
    is the padding key and nothing is read."""
    g = torch.Generator(device=cuda).manual_seed(3)
    cap, d = 1 << 13, 128
    rows, scales, norms = _i8_rows(g, cap, d, cuda)
    buf = torch.empty(cap * d + 1, dtype=torch.int8, device=cuda)
    dec = buf[1:].view(cap, d)
    dec.copy_(rows)
    assert dec.data_ptr() % 4 != 0
    nbuf = torch.empty(cap + 1, device=cuda)
    norms_odd = nbuf[1:]
    norms_odd.copy_(norms)  # not 16-byte aligned: the wrapper copies it
    q = torch.rand((100, d), generator=g, device=cuda) * 0.1
    k = HI.replica_i8_tile_keys(q, dec, scales, norms_odd)
    t = HI.replica_i8_tile_keys_plain(q, rows, scales, norms)
    assert torch.equal(k.view(torch.int32), t.view(torch.int32))
    pad = torch.full_like(norms, float("inf"))
    k = HI.replica_i8_tile_keys(q, rows, scales, pad, n_valid=0)
    t = HI.replica_i8_tile_keys_plain(q, rows, scales, pad)
    assert torch.equal(k.view(torch.int32), t.view(torch.int32))


@pytest.mark.parametrize("qn,d,cap_v,with_pen", [
    (70, 128, 256, True), (33, 30, 40, False), (8, 64, 256, True)])
def test_ivf_i8_windows_match_twin(cuda, qn, d, cap_v, with_pen):
    """Kernel G with duplicates, vlen padding and the pen stream; D=30
    takes the byte-wise staging, ragged Q and cap_v the kernel's edges."""
    g = torch.Generator(device=cuda).manual_seed(qn)
    nwin, u = 30, 50
    rows, scales, _ = _i8_rows(g, nwin * cap_v, d, cuda)
    vlen_w = torch.randint(0, cap_v + 1, (nwin,), generator=g, device=cuda,
                           dtype=torch.int32)
    flat = torch.sort(torch.randint(0, nwin, (u,), generator=g, device=cuda,
                                    dtype=torch.int32)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda),
                     (flat[1:] == flat[:-1]).to(torch.int32)])
    pen = None
    if with_pen:
        pen = torch.where(torch.rand(nwin * cap_v, generator=g, device=cuda) < 0.3,
                          float("inf"), 0.0).to(torch.float32)
    q = torch.rand((qn, d), generator=g, device=cuda) * 0.1
    vl = vlen_w[flat.long()]
    before = HI.ivf_i8_window_tile_minima.launches
    v_k, a_k = HI.ivf_i8_window_tile_minima(q, rows, scales, flat, dup, vl,
                                            cap_v, pen=pen)
    torch.cuda.synchronize()
    assert HI.ivf_i8_window_tile_minima.launches == before + 1
    v_t, a_t = HI.ivf_i8_window_tile_minima_plain(q, rows, scales, flat, dup,
                                                  vl, cap_v, pen=pen)
    assert_keys_match(*_np(v_k, a_k, v_t, a_t))
    cols = np.repeat(dup.cpu().numpy() != 0, 2 * cap_v // 8)
    assert (a_k.cpu().numpy()[:, cols] == 0).all()


# Kernel G (the s8 tensor-core kernel over the windows' int8 rows): Q
# around the m64 query tile, where both consumer warpgroups share it (Q <=
# 64) or each takes its own (65, 127), and past one block's 128 rows (200);
# cap_v from 8 to 1024 (U * cap_v a multiple of 128 or not); D a whole
# chunk (128), ragged (100: the rows' units 4-byte aligned, the last one
# cut) and past the resident queries' 512 (960: 8 chunks); every entry a
# duplicate, every vlen 0, ragged U (51 entries of 24 rows), rows whose
# base is not 4-byte aligned (byte loads).
_G_CASES = ([(qn, 128, 256, True, "") for qn in (1, 8, 33, 64, 65, 127, 200)]
            + [(33, 100, cap_v, False, "") for cap_v in (8, 24, 128, 256, 1024)]
            + [(qn, d, 128, True, "") for qn in (8, 65) for d in (100, 960)]
            + [(40, 128, 64, True, "all dup"), (40, 128, 64, False, "vlen 0"),
               (70, 100, 24, True, "u51"), (64, 128, 256, False, "unaligned"),
               (200, 960, 1024, False, "")])


@pytest.mark.parametrize("qn,d,cap_v,with_pen,case", _G_CASES)
def test_ivf_i8_windows_edges(cuda, qn, d, cap_v, with_pen, case):
    g = torch.Generator(device=cuda).manual_seed(qn * 7 + d + cap_v)
    nwin, u = 30, 51 if case == "u51" else 50
    rows, scales, _ = _i8_rows(g, nwin * cap_v, d, cuda)
    if case == "unaligned":
        buf = torch.empty(nwin * cap_v * d + 3, dtype=torch.int8, device=cuda)
        rows = buf[3:].view(nwin * cap_v, d).copy_(rows)
        assert rows.data_ptr() % 4 != 0
    vlen_w = torch.randint(0, cap_v + 1, (nwin,), generator=g, device=cuda,
                           dtype=torch.int32)
    flat = torch.sort(torch.randint(0, nwin, (u,), generator=g, device=cuda,
                                    dtype=torch.int32)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda),
                     (flat[1:] == flat[:-1]).to(torch.int32)])
    pen = None
    if with_pen:
        pen = torch.where(torch.rand(nwin * cap_v, generator=g, device=cuda) < 0.3,
                          float("inf"), 0.0).to(torch.float32)
    q = torch.rand((qn, d), generator=g, device=cuda) * (0.1 * min(1.0, (128 / d) ** 0.5))
    vl = vlen_w[flat.long()]
    if case == "all dup":
        dup = torch.ones_like(dup)
    elif case == "vlen 0":
        vl = torch.zeros_like(vl)
    before = HI.ivf_i8_window_tile_minima.launches
    v_k, a_k = HI.ivf_i8_window_tile_minima(q, rows, scales, flat, dup, vl, cap_v, pen=pen)
    torch.cuda.synchronize()
    assert HI.ivf_i8_window_tile_minima.launches == before + 1
    v_t, a_t = HI.ivf_i8_window_tile_minima_plain(q, rows, scales, flat, dup, vl, cap_v,
                                                  pen=pen)
    if case in ("all dup", "vlen 0"):  # every score +inf; the slots still agree
        assert not torch.isfinite(v_k).any() and not torch.isfinite(v_t).any()
        assert torch.equal(a_k, a_t)
    else:
        assert_keys_match(*_np(v_k, a_k, v_t, a_t))
    cols = np.repeat(dup.cpu().numpy() != 0, 2 * cap_v // 8)
    assert (a_k.cpu().numpy()[:, cols] == 0).all()


def _assert_minima(v_k, a_k, v_t, a_t, exact_tie_slot=None):
    """Kernels H, I, J against their twins: the keys' tolerance, the
    padding tiles (the last 300 slots hold +inf norms, two whole tiles among
    them) at their first slot, and in the exact reduce the tile whose rows
    are all equal (slots 512..639) at its first slot."""
    assert_keys_match(*_np(v_k, a_k, v_t, a_t))
    pad = ~torch.isfinite(v_t)
    assert torch.equal(a_k[pad], a_t[pad])
    if exact_tie_slot is not None:
        assert (a_k[:, exact_tie_slot // 128] == exact_tie_slot).all()


@pytest.mark.parametrize("qn,d,packed", [(40, 70, True), (40, 70, False),
                                         (8, 128, True), (100, 128, False)])
def test_replica_scan_tile_minima_matches_twin(cuda, qn, d, packed):
    """Kernel H in both reduces; D=70 takes the element-wise staging."""
    g = torch.Generator(device=cuda).manual_seed(qn + d)
    cap = 1 << 15
    dec = (torch.rand((cap, d), generator=g, device=cuda) * 0.08).to(torch.bfloat16)
    dec[512:640] = dec[512]
    norms = (dec.float() ** 2).sum(1, keepdim=True)
    norms[-300:] = float("inf")
    q = torch.rand((qn, d), generator=g, device=cuda) * 0.08
    before = H.replica_scan_tile_minima.launches
    v_k, a_k = H.replica_scan_tile_minima(q, dec, norms, packed=packed)
    torch.cuda.synchronize()
    assert H.replica_scan_tile_minima.launches == before + 1
    v_t, a_t = H.replica_scan_tile_minima_plain(q, dec, norms, packed=packed)
    _assert_minima(v_k, a_k, v_t, a_t, None if packed else 512)


@pytest.mark.parametrize("qn,d", [(5, 70), (300, 128), (8, 1040)])
def test_tc_queries_i8_match_quantize_queries(cuda, qn, d):
    """F and I's one-launch query quantization equals quantize_queries_i8
    (the twins' torch ops) bit for bit, rows zero past D."""
    from rii_tpu_torch.ops import _build
    g = torch.Generator(device=cuda).manual_seed(qn + d)
    q = torch.randn((qn, d), generator=g, device=cuda)
    q[0] = 0.0  # an all-zero row: the scale's floor
    scales = torch.rand(d, generator=g, device=cuda) * (0.1 / 127) + 1e-5
    out, ldq, alpha = HI._tc_queries_i8(_build.load_library("replica_tc"), q, scales)
    q_i8, a_t = HI.quantize_queries_i8(q, scales)
    assert ldq % 16 == 0 and out.shape == (qn, ldq)
    assert torch.equal(out[:, :d], q_i8) and not out[:, d:].any()
    assert torch.equal(alpha, a_t)


@pytest.mark.parametrize("qn,d", _I8_EDGES + [(8, 1024), (300, 1024)])
def test_replica_i8_scan_tile_minima_matches_twin(cuda, qn, d):
    """Kernel I; the cross term is exact, so the minima and slots are
    bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(qn + d)
    cap = 1 << 15
    rows, scales, norms = _i8_rows(g, cap, d, cuda)
    norms = norms[:, None].contiguous()
    norms[-300:] = float("inf")
    q = torch.rand((qn, d), generator=g, device=cuda) * 0.1
    before = HI.replica_i8_scan_tile_minima.launches
    v_k, a_k = HI.replica_i8_scan_tile_minima(q, rows, scales, norms)
    torch.cuda.synchronize()
    assert HI.replica_i8_scan_tile_minima.launches == before + 1
    v_t, a_t = HI.replica_i8_scan_tile_minima_plain(q, rows, scales, norms)
    _assert_minima(v_k, a_k, v_t, a_t)
    assert torch.equal(v_k.view(torch.int32), v_t.view(torch.int32))
    assert torch.equal(a_k, a_t)


def test_replica_i8_scan_tile_minima_misaligned_rows(cuda):
    """Kernel I over D=128 rows whose base is not 16-byte aligned: the
    loaded path, bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(4)
    cap, d = 1 << 12, 128
    rows, scales, norms = _i8_rows(g, cap, d, cuda)
    buf = torch.empty(cap * d + 2, dtype=torch.int8, device=cuda)
    dec = buf[2:].view(cap, d)
    dec.copy_(rows)
    assert dec.data_ptr() % 16 != 0
    norms = norms[:, None].contiguous()
    q = torch.rand((130, d), generator=g, device=cuda) * 0.1
    v_k, a_k = HI.replica_i8_scan_tile_minima(q, dec, scales, norms)
    v_t, a_t = HI.replica_i8_scan_tile_minima_plain(q, rows, scales, norms)
    assert torch.equal(v_k.view(torch.int32), v_t.view(torch.int32))
    assert torch.equal(a_k, a_t)


# Kernel J (the tensor-core scan over row-major codes decoded by its
# producer): Ds a multiple of 8 (16-byte codeword units: M=8, Ds=16, and
# M=12, Ds=8), a multiple of 4 only (8-byte halves: M=32, Ds=4, the ops
# shape, and M=24) or neither (M=5, Ds=3: element by element); M a multiple
# of 16 (a chunk's codes one 16-byte load) or not (5, 8, 12, 24: narrower
# loads); in both reduces. Cases: "unaligned" codes (base 1 byte past a
# 16-byte boundary: byte loads), "one tile" (cap 128, below the JAX blk
# rule), "tail" (the last 20000 slots +inf, as past n_valid). M odd at
# Ds=4, and Ds=12, give D % 8 == 4 (the last unit's second half lies past
# D): M=25, Ds=4 and M=5, Ds=12 with the codebook in shared memory, M=101,
# Ds=4 and M=25, Ds=12 with it read through L1.
_J_CASES = [pytest.param(*c, "", id="-".join(map(str, c))) for c in (
    (13, 8, 256, 16, False), (8, 32, 256, 4, True), (40, 5, 100, 3, False),
    (40, 5, 100, 3, True))] + [
    (130, 32, 256, 4, False, "unaligned"), (130, 32, 256, 4, True, "unaligned"),
    (65, 24, 256, 4, False, ""), (65, 12, 256, 8, True, ""),
    (300, 32, 256, 4, False, "one tile"), (1, 8, 256, 16, True, "one tile"),
    (200, 32, 256, 4, False, "tail"), (1024, 32, 256, 4, True, "tail")] + [
    (qn, m, 256, ds, packed, "") for qn, m, ds in (
        (200, 25, 4), (40, 5, 12), (40, 101, 4), (40, 25, 12))
    for packed in (False, True)]


@pytest.mark.parametrize("qn,m,ks,ds,packed,case", _J_CASES)
def test_pq_scan_tile_minima_matches_twin(cuda, monkeypatch, qn, m, ks, ds, packed, case):
    """Kernel J against its twin; the last 300 slots hold +inf norms, and
    the rows of slots 512..639 are equal (the exact reduce's tie)."""
    g = torch.Generator(device=cuda).manual_seed(qn + m)
    cap = 128 if case == "one tile" else 1 << 15
    if case == "one tile":  # the kernel steps by 128 slots; JAX's blk rule does not
        monkeypatch.setattr(HP, "_check_rowmajor", lambda cap, blk, norms_col: None)
    cw = torch.rand((m, ks, ds), generator=g, device=cuda) * (0.4 / ds)
    codes = torch.randint(0, ks, (cap, m), generator=g, device=cuda,
                          dtype=torch.uint8)
    if case == "unaligned":
        buf = torch.empty(cap * m + 16, dtype=torch.uint8, device=cuda)
        codes = buf[1:1 + cap * m].view(cap, m).copy_(codes)
        assert codes.data_ptr() % 16 != 0
    if cap >= 640:
        codes[512:640] = codes[512]
    cwp = HP.build_padded_codewords(cw.cpu().numpy(), device=cuda)
    cw16 = cw.to(torch.bfloat16).float()
    dec = cw16[torch.arange(m, device=cuda), codes.long()].reshape(cap, -1)
    norms = (dec * dec).sum(1, keepdim=True)
    norms[-(20000 if case == "tail" else min(300, cap // 4)):] = float("inf")
    q = torch.rand((qn, m * ds), generator=g, device=cuda) * 0.1
    before = HP.pq_scan_tile_minima.launches
    v_k, a_k = HP.pq_scan_tile_minima(q, codes, norms, cwp, packed=packed)
    torch.cuda.synchronize()
    assert HP.pq_scan_tile_minima.launches == before + 1
    v_t, a_t = HP.pq_scan_tile_minima_plain(q, codes, norms, cwp, packed=packed)
    _assert_minima(v_k, a_k, v_t, a_t, None if packed or cap < 640 else 512)


def test_wrapper_raises_on_mixed_devices(cuda):
    with pytest.raises(ValueError):
        H.replica_tile_keys(torch.zeros((2, 8)),
                            torch.zeros((8, 128), dtype=torch.bfloat16, device=cuda),
                            torch.zeros(128, device=cuda))
