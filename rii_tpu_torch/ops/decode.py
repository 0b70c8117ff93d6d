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
