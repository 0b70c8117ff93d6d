"""Product Quantization codec in PyTorch (counterpart of ``rii_tpu.models.pq``).

The same ``nanopq.PQ``-style contract: ``PQ(M, Ks)``, ``fit``, ``encode`` to
(N, M) uint8, ``decode`` to (N, D) float32, ``codewords`` as an (M, Ks, Ds)
float32 ndarray, ``from_codewords`` and ``__eq__``. Inputs and outputs are
numpy arrays; the work runs on ``device``.
"""

import numpy as np
import torch

from rii_tpu_torch._device import resolve_device
from rii_tpu_torch.models.kmeans import kmeans_fit_batched
from rii_tpu_torch.ops.decode import onehot_decode_exact

_BLOCK = 16384  # rows per encode/decode step: bounds the (B, M, Ks) transient


class PQ:
    """Product quantizer with Ks codewords per each of M sub-spaces.

    Args:
        M: number of sub-spaces; D must be divisible by M.
        Ks: codewords per sub-space, at most 256 so that codes fit in uint8.
        verbose: print training info.
        seed: seed of the ``torch.Generator`` that picks the k-means init.
        device: where fit/encode/decode run: "cuda" (the default; raises
            where no card is visible) or "cpu". Never detected.
    """

    def __init__(self, M, Ks=256, verbose=False, seed=123, device="cuda"):
        assert 0 < Ks <= 256, "Ks must be <= 256 so that each code fits in uint8"
        self.M = int(M)
        self.Ks = int(Ks)
        self.verbose = bool(verbose)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.code_dtype = np.uint8
        self.codewords = None  # (M, Ks, Ds) float32, set by fit()
        self.Ds = None

    @classmethod
    def from_codewords(cls, codewords, verbose=False, device="cuda"):
        """A fitted codec from an existing (M, Ks, Ds) codeword array (for
        example one trained by ``rii_tpu.PQ``): codes decode identically."""
        codewords = np.ascontiguousarray(codewords, dtype=np.float32)
        assert codewords.ndim == 3, "codewords must be (M, Ks, Ds)"
        m, ks, ds = codewords.shape
        pq = cls(M=m, Ks=ks, verbose=verbose, device=device)
        pq.codewords = codewords
        pq.Ds = ds
        return pq

    def fit(self, vecs, iter=20, seed=None):
        """Train codewords on vecs (N, D) float32. Returns self."""
        vecs = np.asarray(vecs)
        assert vecs.ndim == 2
        assert vecs.dtype == np.float32
        n, d = vecs.shape
        assert d % self.M == 0, "D must be divisible by M"
        assert self.Ks <= n, "N must be >= Ks"
        self.Ds = d // self.M
        if seed is not None:
            self.seed = int(seed)
        if self.verbose:
            print(f"PQ training: M={self.M}, Ks={self.Ks}, D={d}, N={n}, iter={iter}")
        sub = torch.tensor(vecs, device=self.device).reshape(
            n, self.M, self.Ds).transpose(0, 1).contiguous()  # (M, N, Ds)
        gen = torch.Generator().manual_seed(self.seed)
        centers, _ = kmeans_fit_batched(sub, k=self.Ks, iters=int(iter),
                                        generator=gen)
        self.codewords = centers.cpu().numpy().astype(np.float32)
        return self

    def _check_fitted(self):
        assert self.codewords is not None, "Please fit the PQ instance first"

    def encode(self, vecs):
        """vecs (N, D) float32 -> PQ codes (N, M) uint8."""
        self._check_fitted()
        vecs = np.asarray(vecs)
        assert vecs.ndim == 2
        assert vecs.dtype == np.float32
        n, d = vecs.shape
        assert d == self.M * self.Ds
        cw = torch.tensor(self.codewords, device=self.device)
        csq = (cw * cw).sum(-1)  # (M, Ks); ||v||^2 cannot change the argmin
        out = np.empty((n, self.M), dtype=np.uint8)
        for s in range(0, n, _BLOCK):
            v = torch.tensor(vecs[s:s + _BLOCK], device=self.device)
            v = v.reshape(-1, self.M, self.Ds)
            cross = torch.einsum("bmd,mkd->bmk", v, cw)
            codes = torch.argmin(csq[None] - 2.0 * cross, dim=-1)
            out[s:s + _BLOCK] = codes.to(torch.uint8).cpu().numpy()
        return out

    def decode(self, codes):
        """codes (N, M) uint8 -> reconstructed vecs (N, D) float32."""
        self._check_fitted()
        codes = np.asarray(codes)
        assert codes.ndim == 2 and codes.shape[1] == self.M
        assert codes.dtype == self.code_dtype
        cw = torch.tensor(self.codewords, device=self.device)
        out = np.empty((codes.shape[0], self.M * self.Ds), dtype=np.float32)
        for s in range(0, codes.shape[0], _BLOCK):
            c = torch.tensor(codes[s:s + _BLOCK], device=self.device)
            out[s:s + _BLOCK] = onehot_decode_exact(c, cw).cpu().numpy()
        return out

    @property
    def D(self):
        return None if self.Ds is None else self.M * self.Ds

    def __eq__(self, other):
        if type(other) is not type(self):
            return False
        if (self.M, self.Ks) != (other.M, other.Ks):
            return False
        if (self.codewords is None) != (other.codewords is None):
            return False
        if self.codewords is None:
            return True
        return np.array_equal(self.codewords, other.codewords)

    def __repr__(self):
        return (f"{type(self).__name__}(M={self.M}, Ks={self.Ks}, "
                f"fitted={self.codewords is not None}, device={self.device})")
