"""Optimized Product Quantization in PyTorch (counterpart of
``rii_tpu.models.opq``): PQ plus a learned orthonormal rotation.

The same ``nanopq.OPQ``-style contract: ``fit``, ``encode``, ``decode``,
``rotate``, ``codewords``, ``rotation_matrix``, ``from_codewords`` and
``__eq__``. Training alternates between fitting the PQ codebooks on rotated
data and solving the orthogonal Procrustes problem
``min_R ||X R - X_hat||_F`` by an SVD, on the codec's device in float32
(``resolve_device`` turns TF32 off on the card).
"""

import numpy as np
import torch

from rii_tpu_torch.models.pq import PQ

_ROTATE_CHUNK = 1 << 20  # rows a rotation step: bounds the device transient


def _procrustes(x, x_hat):
    """The orthonormal R minimising ||x @ R - x_hat||: U @ Vt of
    svd(x^T x_hat)."""
    u, _, vt = torch.linalg.svd(x.T @ x_hat, full_matrices=False)
    return u @ vt


class OPQ(PQ):
    """OPQ codec: a learned rotation R followed by PQ in the rotated space.

    ``encode`` rotates its inputs; ``decode`` returns vectors in the
    *rotated* space (as nanopq does), so queries go through :meth:`rotate`
    before distances are taken; the ``Rii`` engine does this.
    """

    def __init__(self, M, Ks=256, verbose=False, seed=123, device="cuda"):
        super().__init__(M=M, Ks=Ks, verbose=verbose, seed=seed, device=device)
        self.rotation_matrix = None  # (D, D) float32

    @classmethod
    def from_codewords(cls, codewords, rotation_matrix, verbose=False,
                       device="cuda"):
        """A fitted OPQ from (M, Ks, Ds) codewords and a (D, D) rotation
        (for example ``rii_tpu.OPQ``'s or nanopq's ``codewords`` and ``R``):
        codes of the source codec decode identically."""
        opq = super().from_codewords(codewords, verbose=verbose, device=device)
        rot = np.ascontiguousarray(rotation_matrix, dtype=np.float32)
        d = opq.M * opq.Ds
        assert rot.shape == (d, d), f"rotation must be ({d}, {d})"
        opq.rotation_matrix = rot
        return opq

    def fit(self, vecs, iter=20, rotation_iter=10, seed=None,
            rotation_sample=1 << 18):
        """Alternate rotation and codebook updates, then a final PQ fit on
        every row. The alternations run on at most ``rotation_sample`` rows,
        drawn with ``RandomState(seed)``, so their device memory is bounded
        whatever N is. Returns self."""
        vecs = np.asarray(vecs)
        assert vecs.ndim == 2 and vecs.dtype == np.float32
        n, d = vecs.shape
        assert d % self.M == 0
        if seed is not None:
            self.seed = int(seed)
        if n > rotation_sample:
            pick = np.random.RandomState(self.seed).permutation(n)[:rotation_sample]
            sample = np.ascontiguousarray(vecs[pick])
        else:
            sample = vecs
        x = torch.tensor(sample, device=self.device)
        rot = torch.eye(d, dtype=torch.float32, device=self.device)
        # a few inner k-means iterations an alternation; the final fit runs
        # the full budget
        inner_iter = max(2, int(iter) // 4)
        for it in range(int(rotation_iter)):
            xr = (x @ rot).cpu().numpy()
            super().fit(xr, iter=inner_iter)
            x_hat = torch.tensor(super().decode(super().encode(xr)),
                                 device=self.device)
            rot = _procrustes(x, x_hat)
            if self.verbose:
                err = float(((x @ rot - x_hat) ** 2).sum(-1).mean())
                print(f"OPQ alternation {it}: recon error {err:.6f}")
        self.rotation_matrix = rot.cpu().numpy().astype(np.float32)
        super().fit(self.rotate(vecs), iter=int(iter))
        return self

    def rotate(self, vecs):
        """Rotate (D,) or (N, D) vectors into the PQ space, in chunks of
        2^20 rows on the codec's device."""
        assert self.rotation_matrix is not None, "Please fit the OPQ instance first"
        vecs = np.asarray(vecs)
        single = vecs.ndim == 1
        v2 = np.atleast_2d(vecs).astype(np.float32, copy=False)
        r = torch.tensor(self.rotation_matrix, device=self.device)
        out = np.empty_like(v2)
        for lo in range(0, v2.shape[0], _ROTATE_CHUNK):
            chunk = torch.tensor(v2[lo:lo + _ROTATE_CHUNK], device=self.device)
            out[lo:lo + _ROTATE_CHUNK] = (chunk @ r).cpu().numpy()
        return out[0] if single else out

    def encode(self, vecs):
        """Rotate, then PQ-encode: (N, D) float32 -> (N, M) uint8."""
        return super().encode(self.rotate(np.atleast_2d(vecs)))

    def __eq__(self, other):
        if not super().__eq__(other):
            return False
        a, b = self.rotation_matrix, other.rotation_matrix
        if (a is None) != (b is None):
            return False
        return a is None or np.array_equal(a, b)
