"""Batched Lloyd k-means in PyTorch (counterpart of ``rii_tpu.models.kmeans``).

All M sub-space codebooks train at once: the data is (B, N, Ds) and every
step is a batched matrix product. Initialisation draws k distinct rows per
problem from a ``torch.Generator`` seeded by the caller, so a fit is
reproducible for a seed; it does not reproduce ``jax.random``'s picks.
"""

import torch

_CHUNK = 16384  # rows per assignment step: bounds the (B, chunk, K) transient


def _assign_chunk(x, centers, csq):
    """Nearest center for x (B, n, Ds) against centers (B, K, Ds)."""
    dist = csq[:, None, :] - 2.0 * torch.bmm(x, centers.transpose(1, 2))
    return torch.argmin(dist, dim=-1)  # first index on ties


def _lloyd_step(x, centers):
    """One Lloyd iteration. Empty clusters keep their previous center.

    Sums go through a one-hot matrix product rather than a scatter-add, so
    the result is the same from run to run on the card as well."""
    b, _, ds = x.shape
    k = centers.shape[1]
    csq = (centers * centers).sum(-1)
    sums = torch.zeros((b, k, ds), dtype=x.dtype, device=x.device)
    counts = torch.zeros((b, k), dtype=x.dtype, device=x.device)
    for s in range(0, x.shape[1], _CHUNK):
        xc = x[:, s:s + _CHUNK]
        idx = _assign_chunk(xc, centers, csq)
        oh = torch.nn.functional.one_hot(idx, k).to(x.dtype)  # (B, n, K)
        sums += torch.bmm(oh.transpose(1, 2), xc)
        counts += oh.sum(1)
    new = sums / counts.clamp(min=1.0)[..., None]
    return torch.where(counts[..., None] > 0, new, centers)


def kmeans_fit_batched(x, k, iters=20, generator=None):
    """Fit B independent k-means problems: x (B, N, Ds) float32.
    Returns the centers (B, K, Ds)."""
    b, n, _ = x.shape
    picks = torch.stack([torch.randperm(n, generator=generator)[:k]
                         for _ in range(b)]).to(x.device)
    centers = torch.gather(x, 1, picks[..., None].expand(-1, -1, x.shape[2]))
    for _ in range(iters):
        centers = _lloyd_step(x, centers)
    return centers
