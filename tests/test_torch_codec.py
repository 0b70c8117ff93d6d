"""Codec parity of rii_tpu_torch against rii_tpu at shared codewords.

The JAX PQ is fitted once; both packages then hold the same codewords
(``from_codewords``). Encode, decode, the norms and the host-side norms must
agree; the port's own fit is held by quantization error."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rii_tpu import PQ as JPQ
from rii_tpu.models.ivf import code_norms_np as j_code_norms_np
from rii_tpu.ops.decode import build_decoded_cache as j_build_decoded_cache
from rii_tpu.ops.decode import decode_norms as j_decode_norms
from rii_tpu_torch import PQ
from rii_tpu_torch.models.ivf import code_norms_np
from rii_tpu_torch.ops.decode import build_decoded_cache, decode_norms


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    X = rng.random((3000, 32)).astype(np.float32)
    jpq = JPQ(M=4, Ks=16).fit(X[:1000], iter=5)
    return X, jpq, PQ.from_codewords(jpq.codewords)


def test_encode_equal(data):
    X, jpq, tpq = data
    np.testing.assert_array_equal(tpq.encode(X), jpq.encode(X))
    assert tpq.encode(X).dtype == np.uint8


def test_decode_matches(data):
    X, jpq, tpq = data
    codes = jpq.encode(X)
    np.testing.assert_allclose(tpq.decode(codes), jpq.decode(codes), rtol=1e-6)


def test_decode_norms_match(data):
    X, jpq, _ = data
    codes = jpq.encode(X)
    j = np.asarray(j_decode_norms(jnp.asarray(codes), jnp.asarray(jpq.codewords)))
    t = decode_norms(torch.tensor(codes), torch.tensor(jpq.codewords))
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6)


def test_code_norms_np_equal(data):
    X, jpq, _ = data
    codes = jpq.encode(X)
    np.testing.assert_array_equal(code_norms_np(jpq.codewords, codes),
                                  j_code_norms_np(jpq.codewords, codes))


def test_decoded_replica_equal(data):
    """The bf16 replica is the float32 decode rounded once, on both sides."""
    X, jpq, _ = data
    codes = jpq.encode(X[:2048])
    j = j_build_decoded_cache(jnp.asarray(codes), jnp.asarray(jpq.codewords),
                              block=512)
    t = build_decoded_cache(torch.tensor(codes), torch.tensor(jpq.codewords),
                            block=512)
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))


def _quantization_error(pq, X):
    return float(((pq.decode(pq.encode(X)) - X) ** 2).sum(1).mean())


def test_own_fit_quantization_error_within_5pct(data):
    X, jpq, _ = data
    own = PQ(M=4, Ks=16).fit(X[:1000], iter=5)
    assert own.codewords.shape == jpq.codewords.shape
    assert own.codewords.dtype == np.float32
    assert _quantization_error(own, X) <= 1.05 * _quantization_error(jpq, X)


def test_fit_is_reproducible_for_a_seed(data):
    X = data[0]
    a = PQ(M=4, Ks=16, seed=3).fit(X[:500], iter=3)
    b = PQ(M=4, Ks=16, seed=3).fit(X[:500], iter=3)
    assert a == b


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        PQ(M=4, Ks=16, device="cuda")
