"""Sharded search over a mesh of database shards (counterpart of
``rii_tpu.parallel``).

The reference's only parallelism is OpenMP threads over database points.
Here that axis is a mesh ("data" = database shard; or "hosts" x "chips"):
each shard scans its rows on its own device, computes a local top-k, and the
shards' candidates are gathered and merged by one exact top-k. Across
processes the gathers are ``torch.distributed`` collectives (gloo for CPU
tensors, NCCL for CUDA tensors). This package imports ``torch`` and numpy,
never ``jax``.
"""

from rii_tpu_torch.parallel.mesh import (make_mesh, make_mesh_hc, put_sharded,
                                         shard_database)
from rii_tpu_torch.parallel.sharded import (
    make_sharded_linear_scan,
    make_sharded_pqkmeans_step,
)
from rii_tpu_torch.parallel.build import (
    fit_on_mesh,
    predict_on_mesh,
    reconfigure_on_mesh,
)
from rii_tpu_torch.parallel.distributed import ShardedRii, init_distributed

__all__ = [
    "make_mesh",
    "make_mesh_hc",
    "put_sharded",
    "shard_database",
    "make_sharded_linear_scan",
    "make_sharded_pqkmeans_step",
    "fit_on_mesh",
    "predict_on_mesh",
    "reconfigure_on_mesh",
    "ShardedRii",
    "init_distributed",
]
