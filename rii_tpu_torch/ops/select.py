"""Exact k-smallest selection per row: the selection kernel
(``csrc/select_k.cu``) and its plain twin.

The IVF union selects twice a call: each query's probed windows from its
coarse scores, and the best slots from the window kernel's tile minima.
rii_tpu does both with ``lax.top_k``; here both go through
:func:`smallest_k`, which returns the k smallest entries of each row in
ascending (value, column) order, ties to the lower column as ``lax.top_k``
and a stable sort break them. It replaces no Pallas kernel (see the
source's note); it is bound by the bytes it reads, one pass over the rows.

CPU tensors take the twin (a stable sort, sliced); CUDA tensors launch the
kernel, whose wrapper counts its calls in ``smallest_k.launches``. Past
``SELECT_K_MAX`` the kernel does not apply, and callers choose a library
selection by that shape rule (:func:`takes_kernel`).
"""

import ctypes

import torch

from rii_tpu_torch.ops import _build
from rii_tpu_torch.ops.hopper_scan import _ptr, _require, _stream

SELECT_K_MAX = 256  # kMaxK in csrc/select_k.cu
_WARPS = 4  # warps a block of the filter pass, each writing k candidates
_BLOCKS_PER_SM = 8  # filter blocks an SM holds at once: the grid aims at one wave
_MIN_VECS = 16384  # 16-byte loads a filter block takes at least
_MAX_SEGS = 1024


def smallest_k_plain(scores, k):
    """Plain twin: a stable sort of each row, its first min(k, n) columns.
    Returns (values (R, min(k, n)), columns (R, min(k, n)) int64)."""
    vals, cols = torch.sort(scores, dim=1, stable=True)
    kk = min(k, scores.shape[1])
    return vals[:, :kk], cols[:, :kk]


def takes_kernel(scores, k):
    """Whether :func:`smallest_k` launches the kernel for these scores: a
    CUDA tensor and ``k`` within ``SELECT_K_MAX``."""
    return scores.is_cuda and k <= SELECT_K_MAX


def _segments(rows, n, device):
    """Filter blocks a row: about one wave of (row, segment) blocks on the
    card's SMs, none shorter than ``_MIN_VECS`` loads. Fewer, longer blocks
    measured faster at the shard's shapes (each warp's first sorts are a
    fixed cost)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = _BLOCKS_PER_SM * sms // rows
    return max(1, min(want, (n // 4) // _MIN_VECS, _MAX_SEGS))


def smallest_k(scores, k):
    """The k smallest entries of each row of ``scores`` (R, n) float32, in
    ascending (value, column) order; -0 ties +0 and NaNs come last, as in
    ``torch.sort``.

    Returns (values (R, min(k, n)) f32, columns (R, min(k, n)) int64), equal
    bit for bit to :func:`smallest_k_plain`. CPU tensors take the twin;
    CUDA tensors launch the kernel (contiguous rows, k <= SELECT_K_MAX, or
    ValueError)."""
    _require(scores.dim() == 2 and scores.dtype == torch.float32,
             lambda: f"scores must be (R, n) float32, got {tuple(scores.shape)} "
                     f"{scores.dtype}")
    _require(k >= 1, lambda: f"k must be >= 1, got {k}")
    if scores.device.type == "cpu":
        return smallest_k_plain(scores, k)
    _require(scores.is_cuda, lambda: f"scores on {scores.device}: CPU or CUDA")
    _require(k <= SELECT_K_MAX,
             lambda: f"k={k}: the selection kernel takes k <= {SELECT_K_MAX}")
    _require(scores.is_contiguous(), "scores must be contiguous")
    rows, n = scores.shape
    _require(n < 0xFFFFFFFF, "rows must hold fewer than 2^32 - 1 entries")
    kk = min(k, n)
    dev = scores.device
    vals = torch.empty((rows, kk), dtype=torch.float32, device=dev)
    cols = torch.empty((rows, kk), dtype=torch.int64, device=dev)
    if rows == 0 or kk == 0:
        return vals, cols
    segs = _segments(rows, n, dev)
    # the filter pass's candidate lists, then each row's shared threshold
    cand = torch.empty(rows * (segs * _WARPS * kk + 1), dtype=torch.int64,
                       device=dev)
    fn = _build.load_library("select_k").rii_select_k
    _build.configure(fn, [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4)
    _build.check(fn(_ptr(scores), rows, n, kk, segs, _ptr(cand), _ptr(vals),
                    _ptr(cols), _stream(dev)), "smallest_k")
    _build.count_launch(smallest_k)
    return vals, cols


smallest_k.launches = 0
