"""Scans, decode, the IVF union scan and the Hopper kernels' wrappers.

Every scan rests on one identity, the decoded-domain form of the
reference's table-lookup ADC:

    ADC(q, code) = sum_m ||q_m - codeword_m[code_m]||^2
                 = ||q - decode(code)||^2

so a block of PQ codes scores against a query batch as
``||q||^2 - 2 q @ decode(codes)^T + ||decode(codes)||^2``, the last term
precomputed per stored code. Importing this package builds no kernel.
"""

from rii_tpu_torch.ops.decode import decode_norms, onehot_decode
from rii_tpu_torch.ops.ivf import ivf_scan_topk
from rii_tpu_torch.ops.scan import linear_scan_topk, subset_scan_topk

__all__ = [
    "onehot_decode",
    "decode_norms",
    "linear_scan_topk",
    "subset_scan_topk",
    "ivf_scan_topk",
]
