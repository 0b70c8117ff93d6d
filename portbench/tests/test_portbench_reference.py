"""The plain reference and the frozen arithmetic."""

import numpy as np
import pytest
import torch

from portbench.reference import busy, roofline
from portbench.reference.exact import (
    adc64,
    decode,
    distortion,
    encode_excess,
    kmeans64,
    mean_gap,
    nearest,
    recall_at,
    search,
    selection_miss,
    terms,
    widest_gap,
)


def test_recall_arithmetic():
    ids = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [1, 1, 1]])
    assert recall_at(ids, np.array([3, 0, 7, 2])) == 0.5
    assert recall_at(ids[:0], np.array([], dtype=np.int64)) == 0.0


def _chunks(x, step):
    return ((s, x[s:s + step]) for s in range(0, len(x), step))


def test_nearest_is_exact():
    g = torch.Generator().manual_seed(0)
    x = torch.rand(1000, 12, generator=g)
    q = torch.rand(40, 12, generator=g)
    ids, d = nearest(q, _chunks(x, 128))
    full = ((q[:, None, :].double() - x[None].double()) ** 2).sum(-1)
    assert torch.equal(ids, full.argmin(1))
    assert torch.allclose(d, full.min(1).values)
    row_tags = torch.randint(0, 3, (1000,), generator=g)
    q_tags = torch.randint(0, 3, (40,), generator=g)
    ids, _ = nearest(q, _chunks(x, 128), q_tags, row_tags)
    masked = full.masked_fill(row_tags[None] != q_tags[:, None], float("inf"))
    assert torch.equal(ids, masked.argmin(1))


def test_adc_encoding_and_control():
    g = torch.Generator().manual_seed(1)
    cw = torch.rand(4, 16, 3, generator=g)  # M=4, Ks=16, Ds=3
    x = torch.rand(500, 12, generator=g)
    sub = x.view(500, 4, 1, 3)
    codes = ((sub - cw[None]) ** 2).sum(-1).argmin(-1)
    assert encode_excess(x, codes, cw) < 1e-12
    wrong = (codes + 1) % 16
    assert encode_excess(x, wrong, cw) > 0.1
    assert encode_excess(x, codes, cw, dtype=torch.float8_e4m3fn) > 1e-3
    q = torch.rand(5, 12, generator=g)
    c = codes[:7][None].expand(5, 7, 4)
    ref = ((decode(c, cw).double() - q.double()[:, None]) ** 2).sum(-1)
    assert torch.allclose(adc64(q, c, cw), ref)

    def gaps(dtype, form="terms"):
        ids, d = search(q, _chunks(codes, 100), cw, 10, dtype, form)
        ref = adc64(q, codes[ids], cw)
        scale = terms(q, codes[ids], cw)
        return (widest_gap(d.double(), ref, ids >= 0, scale),
                mean_gap(d.double(), ref, ids >= 0, scale))

    fp8, fp8_rows, tf32 = (gaps(torch.float8_e4m3fn),
                           gaps(torch.float8_e4m3fn, "rows"), gaps("tf32"))
    assert fp8[0] > 1e-3 and fp8_rows[1] > 1e-4  # fp8 is far from float64
    assert 1e-7 < tf32[0] < fp8[0] and tf32[1] < fp8_rows[1]
    assert gaps(None) == (0.0, 0.0)  # the exhaustive search is float64 ADC


def test_exhaustive_search_and_selection():
    g = torch.Generator().manual_seed(2)
    cw = torch.rand(4, 16, 3, generator=g)
    codes = torch.randint(0, 16, (700, 4), generator=g)
    q = torch.rand(6, 12, generator=g)
    full = adc64(q, codes[None].expand(6, -1, -1), cw)
    ids, d = search(q, _chunks(codes, 128), cw, 10)
    assert torch.allclose(d, full.sort(1).values[:, :10])
    assert torch.equal(adc64(q, codes[ids], cw), d)
    valid = torch.ones(6, 10, dtype=torch.bool)
    assert selection_miss(d, d[:, -1], valid) == 0.0
    worse = full.sort(1).values[:, 5:15]  # half of each answer below the top
    miss = selection_miss(worse, d[:, -1], valid)
    assert miss == pytest.approx(0.5, abs=0.1)
    valid[:, :2] = False
    assert selection_miss(d, d[:, -1], valid) == pytest.approx(0.2)
    row_tags = torch.randint(0, 2, (700,), generator=g)
    q_tags = torch.tensor([0, 1, 0, 1, 0, 1])
    ids, _ = search(q, _chunks(codes, 128), cw, 10, query_tags=q_tags,
                    row_tags=row_tags)
    assert bool((row_tags[ids] == q_tags[:, None]).all())


def test_reference_codebook():
    g = torch.Generator().manual_seed(3)
    centres = torch.rand(8, 6, generator=g)
    x = (centres[torch.randint(0, 8, (4000,), generator=g)]
         + 0.01 * torch.randn(4000, 6, generator=g))
    cw = kmeans64(x, 2, 8, 10, seed=5)
    assert cw.shape == (2, 8, 3) and cw.dtype == torch.float64
    assert torch.equal(cw, kmeans64(x, 2, 8, 10, seed=5))
    start = kmeans64(x, 2, 8, 0, seed=5)
    assert distortion(x, cw) < distortion(x, start)
    # the quantisation error is the mean squared distance to the nearest
    # codeword, summed over the sub-spaces
    sub = x.double().view(-1, 2, 1, 3)
    want = ((sub - cw[None]) ** 2).sum(-1).min(-1).values.sum(1).mean()
    assert distortion(x, cw) == pytest.approx(float(want))


def test_tf32_rounding():
    from portbench.reference.exact import _round
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0000002,
                      0.1])
    r = _round(x, "tf32")
    assert r[0] == 1.0 and r[1] == 1.0  # a tie goes to even
    assert r[2] == 1.0 + 2 ** -9  # a tie goes to even, upwards
    assert r[3] == -3.0
    assert abs(r[4] - 0.1) <= 0.1 * 2 ** -11


def test_gaps_over_the_terms():
    ref = torch.tensor([1.0, 2.0, 4.0, 8.0], dtype=torch.float64)
    got = torch.tensor([1.0, 2.5, 4.0, 9.0], dtype=torch.float64)
    scale = torch.full((4,), 10.0, dtype=torch.float64)
    valid = torch.tensor([True, True, True, False])
    assert widest_gap(got, ref, valid, scale) == pytest.approx(0.05)
    assert mean_gap(got, ref, valid, scale) == pytest.approx(0.05 / 3)
    none = torch.zeros(4, dtype=torch.bool)
    assert widest_gap(got, ref, none, scale) == 0.0
    assert mean_gap(got, ref, none, scale) == 0.0


@pytest.mark.parametrize("tier,q,rows,m,ms,by", [
    # PERF.md's kernel table: kernel A at Q=1024, cap 2^21 (D=128)
    ("bf16", 1024, 2 ** 21, 32, 0.556, "operations"),
    # kernel C at Q=1024, n_valid 2^25 + 100k, M=8
    ("codes", 1024, 2 ** 25 + 100_000, 8, 8.920, "operations"),
    # a bytes-bound scan: one query over the bf16 replica
    ("bf16", 1, 2 ** 20, 32, 0.0814, "bytes"),
])
def test_roofline_counts(tier, q, rows, m, ms, by):
    sec, bound_by = roofline.scan_bound(tier, q, rows, 128, m)
    assert round(sec * 1e3, 4 if ms < 0.1 else 3) == ms
    assert bound_by == by


def test_busy_union():
    iv = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert busy.merged(iv) == [(0, 12), (20, 30), (40, 41)]
    assert busy.busy_within(iv, 0, 50) == 23
    assert busy.busy_within(iv, 8, 22) == 6
    assert busy.gaps(iv, 0, 50) == [(12, 20), (30, 40), (41, 50)]
