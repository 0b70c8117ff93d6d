"""The benchmark's data, drawn from the run's seed.

SIFT-shaped vectors from a mixture of Gaussian modes: mode centres uniform
in [0, 1)^dim, a common per-dimension sigma, and Zipf mode weights, so that
posting lists come out uneven as SIFT's do. Queries are drawn from the same
mixture, independently of the base, and items get tags with Zipf
popularity.

Every stream is cut into chunks of a fixed number of rows, each drawn by a
generator of its own (seeded from the run's seed, the stream and the chunk's
index), so that any chunk can be drawn again later: the ground truth after
the window regenerates the base chunk by chunk instead of keeping it.
Plain torch; imports nothing of the program.
"""

import numpy as np
import torch

_MASK = (1 << 64) - 1
STREAMS = {"centres": 1, "base": 2, "query": 3, "learn": 4, "tags": 5,
           "traffic": 6, "sample": 7, "fit": 8}


def mix_seed(*parts):
    """A 63-bit generator seed from whole numbers of any size (splitmix64
    over the parts), so that seeds past 32 bits and their streams stay
    apart."""
    x = 0
    for p in parts:
        x = (x + (int(p) & _MASK) + 0x9E3779B97F4A7C15) & _MASK
        z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        x = z ^ (z >> 31)
    return x >> 1


def generator(device, seed, *parts):
    """A torch generator on ``device`` for the stream named by ``parts``."""
    g = torch.Generator(device=device)
    g.manual_seed(mix_seed(seed, *parts))
    return g


def host_rng(seed, *parts):
    """A numpy generator for what the host draws (arrivals, samples)."""
    return np.random.Generator(np.random.PCG64(mix_seed(seed, *parts)))


def zipf_cdf(n, exponent, device):
    """(n,) float64 cumulative weights of ranks 1..n under Zipf(exponent)."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(exponent)
    return torch.tensor(np.cumsum(w) / w.sum(), device=device)


def draw_ranks(cdf, u):
    """Ranks (0-based) of uniform draws ``u`` under the cumulative ``cdf``."""
    return torch.searchsorted(cdf, u).clamp_(max=cdf.shape[0] - 1)


class Mixture:
    """The data of one configuration (its ``data`` block) and one seed."""

    def __init__(self, data, seed, device):
        self.dim = int(data["dim"])
        self.modes = int(data["modes"])
        self.sigma = float(data["sigma"])
        self.chunk_rows = int(data["chunk_rows"])
        self.seed = int(seed)
        self.device = torch.device(device)
        g = generator(self.device, self.seed, STREAMS["centres"])
        self.centres = torch.rand((self.modes, self.dim), generator=g,
                                  device=self.device)
        self.cdf = zipf_cdf(self.modes, data["zipf"], self.device)

    def chunk(self, stream, index, rows):
        """Chunk ``index`` of ``stream``: (rows, dim) float32 on the device."""
        g = generator(self.device, self.seed, STREAMS[stream], index)
        u = torch.rand(rows, generator=g, device=self.device,
                       dtype=torch.float64)
        x = torch.randn((rows, self.dim), generator=g, device=self.device)
        return x.mul_(self.sigma).add_(self.centres[draw_ranks(self.cdf, u)])

    def chunks(self, stream, total, start=0, stop=None):
        """(first row, rows) of every chunk of a ``total``-row stream that
        holds rows of [start, stop), cut to that range. A chunk's size
        depends on ``total`` alone, so a row reads the same whatever range
        asks for it."""
        stop = total if stop is None else min(stop, total)
        c = self.chunk_rows
        for i in range(start // c, -(-stop // c)):
            s = i * c
            x = self.chunk(stream, i, min(c, total - s))
            lo, hi = max(start, s) - s, min(stop, s + c) - s
            yield s + lo, x[lo:hi]

    def take(self, stream, total, start=0, stop=None):
        """Rows [start, stop) of a ``total``-row stream as one tensor."""
        return torch.cat([x for _, x in self.chunks(stream, total, start,
                                                    stop)])

    def rows_at(self, stream, total, ids):
        """Rows ``ids`` (numpy int) of a ``total``-row stream, in that order,
        drawing only the chunks that hold them."""
        ids = np.asarray(ids, dtype=np.int64)
        out = torch.empty((len(ids), self.dim), device=self.device)
        c = self.chunk_rows
        for i in np.unique(ids // c):
            pos = np.flatnonzero(ids // c == i)
            x = self.chunk(stream, int(i), min(c, total - int(i) * c))
            sel = torch.as_tensor(ids[pos] - i * c, device=self.device)
            out[torch.as_tensor(pos, device=self.device)] = x[sel]
        return out


def tags(n, ntags, exponent, seed, device):
    """(n,) numpy int64 tag of each item: one tag an item, with Zipf
    popularity over ``ntags`` tags (tag 0 the most popular)."""
    g = generator(device, seed, STREAMS["tags"])
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    return draw_ranks(zipf_cdf(ntags, exponent, device), u).cpu().numpy()
