"""Codecs and clustering: PQ, OPQ, k-means, PQk-means and the IVF layouts."""

from rii_tpu_torch.models.opq import OPQ
from rii_tpu_torch.models.pq import PQ
from rii_tpu_torch.models.pqkmeans import pqkmeans_fit, pqkmeans_predict

__all__ = ["PQ", "OPQ", "pqkmeans_fit", "pqkmeans_predict"]
