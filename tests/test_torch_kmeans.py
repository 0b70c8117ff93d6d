"""The port's k-means (rii_tpu_torch.models.kmeans: assign, the Lloyd step,
kmeans_fit, kmeans_fit_batched) against rii_tpu's on the same seeded
inputs.

rii_tpu draws its initial rows from ``jax.random`` and the port from a
``torch.Generator``, so a fit is held by its quantization error, not by
bits (ROADMAP's codec rule); the assignment and one Lloyd step from the
same centers are held value for value."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rii_tpu.models import kmeans as JK
from rii_tpu_torch import PQ
from rii_tpu_torch.models import kmeans as TK

from _torch_parity import NEAR_TIE_RTOL


def _blobs(n, d, n_blobs, seed, spread=0.3):
    rng = np.random.RandomState(seed)
    centers = rng.normal(0, 1, (n_blobs, d))
    x = centers[rng.randint(0, n_blobs, n)] + spread * rng.normal(0, 1, (n, d))
    return x.astype(np.float32)


@pytest.mark.parametrize("n,d,k", [(3000, 16, 32), (40000, 8, 256)])
def test_assign_matches_rii_tpu(n, d, k):
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    c = rng.normal(0, 1, (k, d)).astype(np.float32)
    it, dt = TK.assign(torch.from_numpy(x), torch.from_numpy(c))
    ij, dj = (np.asarray(a) for a in JK.assign(jnp.asarray(x), jnp.asarray(c)))
    it, dt = it.numpy(), dt.numpy()
    assert it.dtype == np.int64 and dt.dtype == np.float32 and it.shape == (n,)
    diff = np.nonzero(it != ij)[0]
    if diff.size:  # near-ties only
        x64, c64 = x[diff].astype(np.float64), c.astype(np.float64)
        da = ((x64 - c64[it[diff]]) ** 2).sum(1)
        db = ((x64 - c64[ij[diff]]) ** 2).sum(1)
        assert (np.abs(da - db) / da < NEAR_TIE_RTOL).all()
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=0)


def test_lloyd_step_matches_rii_tpu_with_an_empty_cluster():
    rng = np.random.RandomState(2)
    x = rng.normal(0, 1, (2000, 8)).astype(np.float32)
    c = x[rng.choice(2000, 16, replace=False)].copy()
    c[5] = 100.0  # no row is nearest to it: it keeps its place
    ct = TK._lloyd_step(torch.from_numpy(x)[None], torch.from_numpy(c)[None])[0]
    cj = np.asarray(JK._lloyd_step(jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-5, atol=1e-5)
    assert (ct[5] == 100.0).all()


def test_fit_quantization_error_within_2pct_of_rii_tpu():
    """Clustered data (256 blobs), k=16, 20 iterations: the mean squared
    error summed over three seeds of each package's init (one seed's init
    moves the error of either package by a few percent)."""
    x = _blobs(4000, 8, 256, seed=0)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    err_t = err_j = 0.0
    for s in range(3):
        ct, at = TK.kmeans_fit(xt, 16, iters=20, generator=torch.Generator().manual_seed(s))
        cj, _ = JK.kmeans_fit(jax.random.PRNGKey(s), xj, k=16, iters=20)
        assert ct.shape == (16, 8) and at.shape == (4000,)
        err_t += float(TK.assign(xt, ct)[1].mean())
        err_j += float(np.asarray(JK.assign(xj, cj)[1]).mean())
    assert err_t <= 1.02 * err_j, (err_t, err_j)


def test_fit_is_reproducible_and_consistent():
    x = torch.from_numpy(_blobs(3000, 8, 32, seed=1))
    a = TK.kmeans_fit(x, 16, iters=10, generator=torch.Generator().manual_seed(7))
    b = TK.kmeans_fit(x, 16, iters=10, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # the assignments are assign()'s at the fitted centers, and the fit
    # lowers the error of its initial rows
    idx, d2 = TK.assign(x, a[0])
    assert torch.equal(a[1], idx)
    picks = torch.randperm(len(x), generator=torch.Generator().manual_seed(7))[:16]
    assert len(set(picks.tolist())) == 16
    assert d2.mean() <= TK.assign(x, x[picks])[1].mean()


def test_kmeans_fit_batched_returns_centers_and_assignments():
    x = torch.from_numpy(np.stack([_blobs(1500, 4, 16, seed=s) for s in range(3)]))
    centers, idx = TK.kmeans_fit_batched(x, 8, iters=5,
                                         generator=torch.Generator().manual_seed(3))
    assert centers.shape == (3, 8, 4) and idx.shape == (3, 1500)
    for b in range(3):
        assert torch.equal(idx[b], TK.assign(x[b], centers[b])[0])
    # one problem fitted alone draws the first problem's rows
    c0, i0 = TK.kmeans_fit(x[0], 8, iters=5, generator=torch.Generator().manual_seed(3))
    assert torch.equal(c0, centers[0]) and torch.equal(i0, idx[0])


def test_pq_fit_codewords_are_the_lloyd_iterations_of_its_seed():
    """PQ.fit keeps its codewords since kmeans_fit_batched also returns the
    assignments: they equal the Lloyd steps from the rows its seed draws,
    bit for bit."""
    x = _blobs(2000, 16, 64, seed=4)
    pq = PQ(M=4, Ks=32, seed=11, device="cpu").fit(x, iter=6)
    sub = torch.from_numpy(x).reshape(2000, 4, 4).transpose(0, 1).contiguous()
    gen = torch.Generator().manual_seed(11)
    picks = torch.stack([torch.randperm(2000, generator=gen)[:32] for _ in range(4)])
    centers = torch.gather(sub, 1, picks[..., None].expand(-1, -1, 4))
    for _ in range(6):
        centers = TK._lloyd_step(sub, centers)
    np.testing.assert_array_equal(pq.codewords, centers.numpy())
