"""The selection kernel (``csrc/select_k.cu``) against its plain twin, on
the card: values and columns equal bit for bit, one launch a call.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is
False (a CUDA kernel has no CPU mode). On a machine with a card and nvcc:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_select.py

This file imports no JAX. Inputs are drawn from four distinct values, so
nearly every selected entry ties with others and the columns decide; rows
hold runs of +inf, and the last row (where there are several) is all +inf.
"""

import pytest
import torch

from rii_tpu_torch.ops import select as S

pytestmark = pytest.mark.gpu

_INF = float("inf")
_VALUES = (-0.75, 0.5, 0.5000001, 2.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _tied(rows, n, seed, dev):
    """(rows, n) float32 from four values, a run of +inf in every row and
    the last of several rows all +inf."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.tensor(_VALUES, device=dev)
    x = vals[torch.randint(0, len(_VALUES), (rows, n), generator=g, device=dev)]
    if n > 2:
        x[:, n // 3:n // 2] = _INF
    if rows > 1:
        x[-1] = _INF
    return x.contiguous()


def _check(x, k):
    before = S.smallest_k.launches
    v, c = S.smallest_k(x, k)
    torch.cuda.synchronize()
    assert S.smallest_k.launches == before + 1
    tv, tc = S.smallest_k_plain(x, k)
    assert v.shape == c.shape == (x.shape[0], min(k, x.shape[1]))
    assert v.dtype == torch.float32 and c.dtype == torch.int64
    assert torch.equal(c, tc)
    assert torch.equal(v.view(torch.int32), tv.contiguous().view(torch.int32))


def _cases():
    out = []
    for k in (1, 20, 64, 256):
        for rows in (1, 8, 512):
            for n in sorted({1, k - 1, k, 31, 4097, 180_000} - {0}):
                out.append((rows, n, k))
        out.append((8, 1 << 21, k))
    return out


@pytest.mark.parametrize("rows,n,k", _cases())
def test_select_matches_twin(cuda, rows, n, k):
    _check(_tied(rows, n, rows * 7919 + n + k, cuda), k)


@pytest.mark.parametrize("rows,n,k", [(512, 1 << 21, 20), (512, 179_604, 64)])
def test_select_at_the_shard_shapes(cuda, rows, n, k):
    """The SIFT1B shard's two selections: kernel D's tile minima (Q=512,
    2^21 columns, topk 10 overfetched twice) and the probe selection over
    its ~179.6k virtual windows (w=64), on continuous scores."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((rows, n), generator=g, device=cuda)
    x[:, : n // 64] = _INF  # a run of duplicate windows
    _check(x, k)
    del x
    torch.cuda.empty_cache()


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_select_any_row_alignment(cuda, offset):
    """Rows whose start is 4, 8 or 12 bytes past a 16-byte boundary: the
    row's head and tail are read one entry at a time."""
    g = torch.Generator(device=cuda).manual_seed(offset)
    base = torch.randn(8 * 5003 + offset, generator=g, device=cuda)
    x = base[offset:].view(8, 5003)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _check(x, 20)


def test_select_descending_rows(cuda):
    """Rows sorted descending: every entry beats the threshold before it,
    so each warp sorts its list as often as the design allows."""
    x = torch.arange(64 * 4096, 0, -1, device=cuda, dtype=torch.float32)
    _check(x.view(64, 4096).contiguous(), 256)


@pytest.mark.parametrize("n", [3001, 180_000])
def test_select_signed_zeros_and_nans(cuda, n):
    """-0 ties +0 and every NaN lies after +inf, as in the stable sort's
    comparisons: held to the twin on the CPU."""
    g = torch.Generator(device=cuda).manual_seed(n)
    vals = torch.tensor([0.0, -0.0, float("nan"), _INF, -1.0], device=cuda)
    x = vals[torch.randint(0, 5, (16, n), generator=g, device=cuda)]
    x[3] = float("nan")
    x = x.contiguous()
    v, c = S.smallest_k(x, 64)
    tv, tc = S.smallest_k_plain(x.cpu(), 64)
    assert torch.equal(c.cpu(), tc)
    assert torch.equal(v.cpu().view(torch.int32), tv.contiguous().view(torch.int32))


def test_select_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((4, 100), device=cuda)
    with pytest.raises(ValueError):
        S.smallest_k(x, S.SELECT_K_MAX + 1)
    with pytest.raises(ValueError):
        S.smallest_k(x.t(), 4)
    with pytest.raises(ValueError):
        S.smallest_k(x.double(), 4)
