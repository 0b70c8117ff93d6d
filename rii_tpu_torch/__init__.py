"""rii-tpu on PyTorch and CUDA: the reconfigurable inverted index (PQ/IVFADC).

A port of the ``rii_tpu`` JAX package to PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper on the bf16 query path (``rii_tpu_torch/csrc``).
Module names follow ``rii_tpu`` so that each counterpart is easy to find.
This package imports ``torch`` and never ``jax``.

The device is always explicit: ``PQ(..., device="cuda")`` and ``Rii(pq)``
(which takes the codec's device, or ``device=``). The default is ``"cpu"``;
asking for CUDA without a card raises.
"""

from rii_tpu_torch.models.pq import PQ
from rii_tpu_torch.rii import Rii

__version__ = "0.1.0"

__all__ = ["PQ", "Rii", "__version__"]
