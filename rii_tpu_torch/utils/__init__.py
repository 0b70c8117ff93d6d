"""Utilities: dataset IO (fvecs/ivecs/bvecs), recall metrics, profiling,
checkpoints (``utils.serialization``) and conversion from the JAX
package's arrays (``utils.convert``)."""

from rii_tpu_torch.utils.io import bvecs_read_batches, fvecs_read, ivecs_read
from rii_tpu_torch.utils.profiling import benchmark_queries, measure_rtt, trace
from rii_tpu_torch.utils.recall import recall_at_r

__all__ = [
    "fvecs_read",
    "ivecs_read",
    "bvecs_read_batches",
    "recall_at_r",
    "trace",
    "measure_rtt",
    "benchmark_queries",
]
