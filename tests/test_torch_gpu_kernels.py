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


def test_wrapper_raises_on_mixed_devices(cuda):
    with pytest.raises(ValueError):
        H.replica_tile_keys(torch.zeros((2, 8)),
                            torch.zeros((8, 128), dtype=torch.bfloat16, device=cuda),
                            torch.zeros(128, device=cuda))
