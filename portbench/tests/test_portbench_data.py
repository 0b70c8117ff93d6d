"""The data generator: deterministic by seed, chunks drawn again alike."""

import numpy as np
import torch

from portbench.reference.datagen import Mixture, host_rng, mix_seed, tags

DATA = {"dim": 8, "modes": 32, "sigma": 0.05, "zipf": 1.0, "chunk_rows": 100}
SEEDS = (0, 7, 2 ** 31 + 5, 2 ** 40 + 3)


def test_same_seed_same_rows():
    for seed in SEEDS:
        a = Mixture(DATA, seed, "cpu").take("base", 250)
        b = Mixture(DATA, seed, "cpu").take("base", 250)
        assert torch.equal(a, b)
        assert a.shape == (250, 8) and a.dtype == torch.float32


def test_seeds_and_streams_differ():
    a = Mixture(DATA, 1, "cpu")
    b = Mixture(DATA, 2, "cpu")
    assert not torch.equal(a.take("base", 100), b.take("base", 100))
    assert not torch.equal(a.take("base", 100), a.take("query", 100))
    assert len({mix_seed(s) for s in SEEDS}) == len(SEEDS)
    assert all(0 <= mix_seed(s, 3) < 2 ** 63 for s in SEEDS)


def test_any_range_reads_the_same_rows():
    m = Mixture(DATA, 11, "cpu")
    whole = m.take("base", 250)
    assert torch.equal(m.take("base", 250, 30, 170), whole[30:170])
    ids = np.array([249, 3, 120, 3, 199])
    assert torch.equal(m.rows_at("base", 250, ids), whole[ids])
    starts = [s for s, _ in m.chunks("base", 250)]
    assert starts == [0, 100, 200]


def test_mixture_is_uneven():
    m = Mixture({**DATA, "chunk_rows": 20000}, 5, "cpu")
    x = m.take("base", 20000)
    # the most popular mode (Zipf rank 1) holds about 1/H_32 of the rows
    near = ((x[:, None, :] - m.centres[None]) ** 2).sum(-1).argmin(1)
    top = torch.bincount(near, minlength=32).max().item() / 20000
    assert 0.15 < top < 0.35


def test_tags_deterministic_and_zipf():
    a = tags(50000, 8, 1.0, 9, "cpu")
    assert np.array_equal(a, tags(50000, 8, 1.0, 9, "cpu"))
    counts = np.bincount(a, minlength=8)
    assert counts[0] > counts[3] > counts[7] > 0
    assert abs(counts[0] / 50000 - 1 / sum(1 / k for k in range(1, 9))) < 0.02


def test_host_rng_deterministic():
    assert np.array_equal(host_rng(3, 6).integers(0, 99, 10),
                          host_rng(3, 6).integers(0, 99, 10))
