"""PQ decode (counterpart of ``rii_tpu.ops.decode``).

The JAX package decodes with one-hot matrix products because a per-element
gather does not vectorise on a TPU. Here a gather from the codebooks does the
same job: ``codewords[m, codes[:, m]]`` for every sub-space at once. The
names follow the JAX module; a gather is exact in float32, so both
``onehot_decode`` and ``onehot_decode_exact`` are the float32 reconstruction.
"""

import torch


def onehot_decode(codes, codewords, dtype=torch.float32):
    """codes (B, M) integer, codewords (M, Ks, Ds) -> (B, M*Ds) in ``dtype``.

    The reconstruction is formed in float32 and then cast, as the JAX
    package's bf16 replica build does."""
    m = codewords.shape[0]
    sub = torch.arange(m, device=codes.device)[None, :]
    dec = codewords.to(torch.float32)[sub, codes.long()]  # (B, M, Ds)
    return dec.reshape(codes.shape[0], -1).to(dtype)


def onehot_decode_exact(codes, codewords):
    """Exact float32 decode, used by the candidate rescore epilogues."""
    return onehot_decode(codes, codewords, dtype=torch.float32)


def build_decoded_cache(codes, codewords, block=262144, dtype=torch.bfloat16):
    """Decode the whole (cap, M) code array to a (cap, D) ``dtype`` replica,
    ``block`` rows at a time so the float32 transient stays bounded."""
    cap = codes.shape[0]
    d = codewords.shape[0] * codewords.shape[2]
    out = torch.empty((cap, d), dtype=dtype, device=codes.device)
    for s in range(0, cap, block):
        out[s:s + block] = onehot_decode(codes[s:s + block], codewords, dtype)
    return out


def decode_norms(codes, codewords):
    """||decode(code)||^2 per code row: (B, M) -> (B,) float32, summed from
    the per-sub-space codeword norm table (M, Ks)."""
    cnorms = (codewords * codewords).sum(-1)  # (M, Ks)
    m = codewords.shape[0]
    sub = torch.arange(m, device=codes.device)[None, :]
    return cnorms[sub, codes.long()].sum(-1)


def dtable(query, codewords):
    """Classic ADC distance table of one (D,) query: (M, Ks) float32 of
    ||q_m - codeword_{m,k}||^2, on the tensors' device.

    The reference's DTable (reference src/rii.h:361-373). The hot paths
    never form it (they use the decoded-domain identity, or kernel E's bf16
    batched :func:`build_dtable`); it is exposed for oracles, debugging and
    external consumers: ADC(q, code) == dtable(q)[m, code_m] summed over m.
    """
    cw = codewords.to(torch.float32)
    m, _, ds = cw.shape
    diff = query.to(torch.float32).reshape(m, 1, ds) - cw
    return (diff * diff).sum(-1)


def adc_oracle(query, codes, codewords):
    """Reference-formulation ADC distances of one query to (B, M) codes
    through the table (slow, exact): sum_m dtable[m, codes[:, m]], (B,)
    float32."""
    dt = dtable(query, codewords)  # (M, Ks)
    sub = torch.arange(dt.shape[0], device=codes.device)[None, :]
    return dt[sub, codes.long()].sum(-1)


def codeword_norms(codewords):
    """(M, Ks, Ds) codewords -> (M, Ks) float32 ||cw[m, k]||^2, the constant
    term of :func:`build_dtable`, summed in order along Ds."""
    return _sum_sq_in_order(codewords.to(torch.float32))


def build_dtable(queries, codewords, dtype=torch.bfloat16, cw_norms=None):
    """(Q, D) queries -> (M, Ks, Q) ADC table ||q_m - cw[m, k]||^2, the
    table of the pq tier's small-Q window kernel (kernel E).

    Formed in float32 as ||cw||^2 - 2 q.cw + ||q_m||^2, the JAX package's
    decoded-domain identity, and then cast to ``dtype`` (bf16: the selection
    class; callers rescore the final top-k exactly). The squared norms are
    summed in order along Ds, as XLA reduces on the CPU, so that the two
    packages round the same float32 values to bf16. ``cw_norms``, the
    :func:`codeword_norms` of ``codewords``, saves recomputing them for
    every batch. Kernel E builds this table itself on the card, bit for bit
    (``csrc/ivf_pq_window.cu``; the einsum's float32 cross term there is
    the in-order fma chain the kernel forms); its CPU twin calls this."""
    cw = codewords.to(torch.float32)  # (M, Ks, Ds)
    m, ks, ds = cw.shape
    qs = queries.to(torch.float32).reshape(-1, m, ds).transpose(0, 1)  # (M, Q, Ds)
    cross = torch.einsum("mkd,mqd->mkq", cw, qs)
    cn = codeword_norms(cw) if cw_norms is None else cw_norms  # (M, Ks)
    qn2 = _sum_sq_in_order(qs)  # (M, Q)
    return (cn[:, :, None] - 2.0 * cross + qn2[:, None, :]).to(dtype)


def _sum_sq_in_order(x):
    """Sum of squares over the last axis, added in index order."""
    sq = x * x
    acc = sq[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + sq[..., j]
    return acc
