"""Lloyd k-means in PyTorch (counterpart of ``rii_tpu.models.kmeans``).

All M sub-space codebooks train at once: the data is (B, N, Ds) and every
step is a batched matrix product; :func:`kmeans_fit` is the one-problem
case. Initialisation draws k distinct rows per problem from a
``torch.Generator`` seeded by the caller, so a fit is reproducible for a
seed; it does not reproduce ``jax.random``'s picks.
"""

import torch

_CHUNK = 16384  # rows per assignment step: bounds the (B, chunk, K) transient


def _assign_chunk(x, centers, csq):
    """Nearest center for x (B, n, Ds) against centers (B, K, Ds): (ids,
    ||c||^2 - 2 x.c at them). ||x||^2 cannot change the argmin."""
    dist = csq[:, None, :] - 2.0 * torch.bmm(x, centers.transpose(1, 2))
    idx = torch.argmin(dist, dim=-1)  # first index on ties
    return idx, torch.gather(dist, -1, idx[..., None])[..., 0]


def _assign_batched(x, centers):
    """_assign_chunk over x (B, N, Ds) in row chunks: (ids (B, N), partial
    distances (B, N))."""
    csq = (centers * centers).sum(-1)
    parts = [_assign_chunk(x[:, s:s + _CHUNK], centers, csq)
             for s in range(0, x.shape[1], _CHUNK)]
    return (torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1] for p in parts], 1))


def assign(x, centers):
    """Nearest-center assignment of x (N, D) to centers (K, D). Returns
    (assignments (N,) int64, squared distances (N,) float32)."""
    idx, val = _assign_batched(x[None], centers[None])
    return idx[0], (x * x).sum(-1) + val[0]


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
        idx, _ = _assign_chunk(xc, centers, csq)
        oh = torch.nn.functional.one_hot(idx, k).to(x.dtype)  # (B, n, K)
        sums += torch.bmm(oh.transpose(1, 2), xc)
        counts += oh.sum(1)
    new = sums / counts.clamp(min=1.0)[..., None]
    return torch.where(counts[..., None] > 0, new, centers)


def kmeans_fit_batched(x, k, iters=20, generator=None):
    """Fit B independent k-means problems: x (B, N, Ds) float32.
    Returns (centers (B, K, Ds), assignments (B, N) int64)."""
    b, n, _ = x.shape
    picks = torch.stack([torch.randperm(n, generator=generator)[:k]
                         for _ in range(b)]).to(x.device)
    centers = torch.gather(x, 1, picks[..., None].expand(-1, -1, x.shape[2]))
    for _ in range(iters):
        centers = _lloyd_step(x, centers)
    return centers, _assign_batched(x, centers)[0]


def kmeans_fit(x, k, iters=20, generator=None):
    """Fit k-means on x (N, D) float32: k distinct rows drawn from
    ``generator`` start it, empty clusters keep their center. Returns
    (centers (K, D), assignments (N,) int64), the assignments those of
    :func:`assign` at the centers."""
    centers, idx = kmeans_fit_batched(x[None], k, iters=iters,
                                      generator=generator)
    return centers[0], idx[0]
