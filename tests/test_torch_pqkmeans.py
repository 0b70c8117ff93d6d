"""PQk-means parity of rii_tpu_torch against rii_tpu at shared codewords
and seed: centers and assignments are equal, apart from argmin near-ties
(distances within 1e-5 relative), which are checked explicitly."""

import numpy as np
import pytest

from rii_tpu import PQ as JPQ
from rii_tpu.models.pqkmeans import pqkmeans_fit as j_fit
from rii_tpu.models.pqkmeans import pqkmeans_predict as j_predict
from rii_tpu_torch.models.pqkmeans import pqkmeans_fit, pqkmeans_predict

from _torch_parity import assert_assignments_equal_but_near_ties


@pytest.fixture(scope="module")
def codes_cw():
    rng = np.random.RandomState(1)
    X = rng.random((5000, 32)).astype(np.float32)
    jpq = JPQ(M=8, Ks=32).fit(X[:1000], iter=3)
    return jpq.encode(X), jpq.codewords


@pytest.mark.parametrize("k,iters", [(16, 1), (16, 3), (50, 5)])
def test_fit_matches_jax(codes_cw, k, iters):
    codes, cw = codes_cw
    cj, aj = j_fit(cw, codes, k=k, iters=iters, seed=0)
    ct, at = pqkmeans_fit(cw, codes, k=k, iters=iters, seed=0, device="cpu")
    assert ct.dtype == np.uint8 and at.dtype == np.int32
    np.testing.assert_array_equal(ct, cj)
    assert_assignments_equal_but_near_ties(cw, codes, ct, aj, at)


def test_predict_matches_jax(codes_cw):
    codes, cw = codes_cw
    centers, _ = j_fit(cw, codes, k=40, iters=3, seed=0)
    aj = j_predict(cw, centers, codes)
    at = pqkmeans_predict(cw, centers, codes, device="cpu")
    assert at.dtype == np.int32 and at.shape == (len(codes),)
    assert_assignments_equal_but_near_ties(cw, codes, centers, aj, at)


def test_last_pass_only_assigns(codes_cw):
    """With one pass the centers are the seeded init pick, unchanged."""
    codes, cw = codes_cw
    ct, _ = pqkmeans_fit(cw, codes, k=10, iters=1, seed=0, device="cpu")
    pick = np.random.RandomState(0).permutation(len(codes))[:10]
    np.testing.assert_array_equal(ct, codes[pick])


def test_empty_cluster_keeps_its_center(codes_cw):
    """Identical codes: every row ties to center 0 (first index), so the
    other centers are empty and keep their init codes, as in rii_tpu."""
    codes, cw = codes_cw
    same = np.repeat(codes[:1], 64, axis=0)
    ct, at = pqkmeans_fit(cw, same, k=4, iters=3, seed=0, device="cpu")
    cj, aj = j_fit(cw, same, k=4, iters=3, seed=0)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(at, np.zeros(64, np.int32))
    np.testing.assert_array_equal(at, aj)
