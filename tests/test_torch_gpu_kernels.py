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
# loaded path, zero-padded queries).
_TC_EDGES = ([(qn, d, cap) for qn in (1, 63, 65, 200) for d in (16, 70, 72, 128)
              for cap in (128, 384)]
             + [(300, 256, 384), (130, 200, 384), (70, 320, 384), (300, 512, 384)]
             + [(1, 520, 384), (200, 520, 128), (65, 960, 384), (300, 962, 384),
                (130, 1700, 384)])


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


@pytest.mark.parametrize("d,cap_v,with_pen", [(37, 40, True), (128, 256, False)])
def test_ivf_window_matches_twin(cuda, d, cap_v, with_pen):
    g = torch.Generator(device=cuda).manual_seed(d)
    nwin, u, qn = 30, 50, 45
    dec = (torch.rand((nwin * cap_v, d), generator=g, device=cuda) * 0.08).to(torch.bfloat16)
    dec[torch.rand(nwin * cap_v, generator=g, device=cuda) < 0.2] = 1e15
    flat = torch.sort(torch.randint(0, nwin, (u,), generator=g, device=cuda,
                                    dtype=torch.int32)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda),
                     (flat[1:] == flat[:-1]).to(torch.int32)])
    pen = None
    if with_pen:
        pen = torch.where(torch.rand(nwin * cap_v, generator=g, device=cuda) < 0.3,
                          float("inf"), 0.0).to(torch.float32)
    q = torch.rand((qn, d), generator=g, device=cuda) * 0.08
    before = H.ivf_window_tile_minima.launches
    v_k, a_k = H.ivf_window_tile_minima(q, dec, flat, dup, cap_v, pen=pen)
    torch.cuda.synchronize()
    assert H.ivf_window_tile_minima.launches == before + 1
    v_t, a_t = H.ivf_window_tile_minima_plain(q, dec, flat, dup, cap_v, pen=pen)
    assert_keys_match(*_np(v_k, a_k, v_t, a_t))
    cols = np.repeat(dup.cpu().numpy() != 0, 2 * cap_v // 8)
    assert (a_k.cpu().numpy()[:, cols] == 0).all()


@pytest.mark.parametrize("qn,m,ks,ds", [(13, 8, 256, 16), (8, 32, 256, 4),
                                        (40, 5, 100, 3)])
def test_pq_tile_keys_matches_twin(cuda, qn, m, ks, ds):
    """Kernel C at 8 queries per block (M=8), at 4 (M=32) and at a ragged
    shape; the last 20000 slots are padding and n_valid skips their tiles
    (a whole block's run of 16384 slots among them)."""
    g = torch.Generator(device=cuda).manual_seed(qn)
    cap = 1 << 15
    cw = torch.rand((m, ks, ds), generator=g, device=cuda) * (0.4 / ds)
    codes_t = torch.randint(0, ks, (m, cap), generator=g, device=cuda,
                            dtype=torch.uint8)
    cw16 = cw.to(torch.bfloat16).float()
    dec = cw16[torch.arange(m, device=cuda), codes_t.T.long()].reshape(cap, -1)
    norms = (dec * dec).sum(1)
    norms[-20000:] = float("inf")
    q = torch.rand((qn, m * ds), generator=g, device=cuda) * 0.1
    before = HP.pq_tile_keys.launches
    k = HP.pq_tile_keys(q, codes_t, norms, cw, n_valid=cap - 20000)
    torch.cuda.synchronize()
    assert HP.pq_tile_keys.launches == before + 1
    t = HP.pq_tile_keys_plain(q, codes_t, norms, cw)
    v_k, l_k = H._unpack(k, 0x7F)
    v_t, l_t = H._unpack(t, 0x7F)
    assert_keys_match(*_np(v_k, l_k, v_t, l_t))


@pytest.mark.parametrize("kernel,qn,ds,cap_v,with_pen", [
    ("D", 70, 16, 256, True), ("D", 33, 3, 40, False),
    ("E", 8, 16, 256, True), ("E", 21, 3, 40, False)])
def test_ivf_pq_windows_match_twin(cuda, kernel, qn, ds, cap_v, with_pen):
    """Kernels D and E with duplicates, vlen padding and the pen stream;
    ragged Q, Ds and cap_v exercise the kernels' edges."""
    g = torch.Generator(device=cuda).manual_seed(qn)
    m, ks, nwin, u = 8, 256, 30, 50
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
    before = fn.launches
    v_k, a_k = fn(q, codes_g, cw, flat, dup, vl, cap_v, pen=pen)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    v_t, a_t = twin(q, codes_g, cw, flat, dup, vl, cap_v, pen=pen)
    assert_keys_match(*_np(v_k, a_k, v_t, a_t))
    cols = np.repeat(dup.cpu().numpy() != 0, 2 * cap_v // 8)
    assert (a_k.cpu().numpy()[:, cols] == 0).all()


def _i8_rows(g, n, d, cuda):
    """Random int8 rows, column scales below 0.1/127 and the dequantized
    rows' squared norms (below 1.3 at D=128)."""
    rows = torch.randint(-127, 128, (n, d), generator=g, device=cuda,
                         dtype=torch.int32).to(torch.int8)
    scales = torch.rand(d, generator=g, device=cuda) * (0.1 / 127) + 1e-5
    norms = ((rows.float() * scales) ** 2).sum(1)
    return rows, scales, norms


@pytest.mark.parametrize("qn,d", [(8, 128), (20, 70), (100, 128)])
def test_replica_i8_tile_keys_matches_twin(cuda, qn, d):
    """Kernel F at each query tile (8, 32, 64) and at a D that is not a
    multiple of 4; the last 20000 slots are padding that n_valid skips.
    The cross term is exact, so the keys are bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(qn)
    cap = 1 << 16
    rows, scales, norms = _i8_rows(g, cap, d, cuda)
    norms[-20000:] = float("inf")
    dec_w = HI.pack_words(rows).T.contiguous()
    q = torch.rand((qn, d), generator=g, device=cuda) * 0.1
    before = HI.replica_i8_tile_keys.launches
    k = HI.replica_i8_tile_keys(q, dec_w, scales, norms, n_valid=cap - 20000)
    torch.cuda.synchronize()
    assert HI.replica_i8_tile_keys.launches == before + 1
    t = HI.replica_i8_tile_keys_plain(q, dec_w, scales, norms)
    v_k, l_k = H._unpack(k, 0x7F)
    v_t, l_t = H._unpack(t, 0x7F)
    assert_keys_match(*_np(v_k, l_k, v_t, l_t))
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


@pytest.mark.parametrize("qn,d", [(8, 128), (20, 70), (100, 128)])
def test_replica_i8_scan_tile_minima_matches_twin(cuda, qn, d):
    """Kernel I at a D that is not a multiple of 16 and at two Q; the
    cross term is exact, so the minima are bit-equal."""
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


@pytest.mark.parametrize("qn,m,ks,ds,packed", [
    (13, 8, 256, 16, False), (8, 32, 256, 4, True), (40, 5, 100, 3, False),
    (40, 5, 100, 3, True)])
def test_pq_scan_tile_minima_matches_twin(cuda, qn, m, ks, ds, packed):
    """Kernel J at 8 queries per block (M=8), at 4 (M=32) and at a ragged
    shape (M=5: codes staged byte by byte) in both reduces."""
    g = torch.Generator(device=cuda).manual_seed(qn + m)
    cap = 1 << 15
    cw = torch.rand((m, ks, ds), generator=g, device=cuda) * (0.4 / ds)
    codes = torch.randint(0, ks, (cap, m), generator=g, device=cuda,
                          dtype=torch.uint8)
    codes[512:640] = codes[512]
    cwp = HP.build_padded_codewords(cw.cpu().numpy(), device=cuda)
    cw16 = cw.to(torch.bfloat16).float()
    dec = cw16[torch.arange(m, device=cuda), codes.long()].reshape(cap, -1)
    norms = (dec * dec).sum(1, keepdim=True)
    norms[-300:] = float("inf")
    q = torch.rand((qn, m * ds), generator=g, device=cuda) * 0.1
    before = HP.pq_scan_tile_minima.launches
    v_k, a_k = HP.pq_scan_tile_minima(q, codes, norms, cwp, packed=packed)
    torch.cuda.synchronize()
    assert HP.pq_scan_tile_minima.launches == before + 1
    v_t, a_t = HP.pq_scan_tile_minima_plain(q, codes, norms, cwp, packed=packed)
    _assert_minima(v_k, a_k, v_t, a_t, None if packed else 512)


def test_wrapper_raises_on_mixed_devices(cuda):
    with pytest.raises(ValueError):
        H.replica_tile_keys(torch.zeros((2, 8)),
                            torch.zeros((8, 128), dtype=torch.bfloat16, device=cuda),
                            torch.zeros(128, device=cuda))
