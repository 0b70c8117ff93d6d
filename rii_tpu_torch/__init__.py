"""rii-tpu on PyTorch and CUDA: the reconfigurable inverted index (PQ/IVFADC).

A port of the ``rii_tpu`` JAX package to PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper on the bf16, int8 and pq query paths
(``rii_tpu_torch/csrc``).
Module names follow ``rii_tpu`` so that each counterpart is easy to find.
This package imports ``torch`` and never ``jax``.

The entry points run on the card unless the caller asks for the CPU:
``PQ(...)``, ``OPQ(...)``, their ``from_codewords(...)``, ``pqkmeans_fit``,
``pqkmeans_predict``, ``engine_from_arrays``, ``load_index``,
``measure_rtt`` and the sharded engine's meshes (``rii_tpu_torch.parallel``:
``make_mesh``, ``make_mesh_hc``, ``init_distributed``) default to
``device="cuda"``, ``Rii(pq)`` takes the codec's device (or ``device=``)
and ``ShardedRii(e)`` the engine's. Asking for CUDA without a card raises; pass ``device="cpu"``
to run on the CPU.
"""

from rii_tpu_torch.models.opq import OPQ
from rii_tpu_torch.models.pq import PQ
from rii_tpu_torch.rii import Rii
from rii_tpu_torch.serving import QueryServer

__version__ = "0.1.0"

__all__ = ["PQ", "OPQ", "Rii", "QueryServer", "__version__"]
