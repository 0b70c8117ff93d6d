"""The port's ADC table and table-lookup ADC (rii_tpu_torch.ops.decode
``dtable`` and ``adc_oracle``) against rii_tpu's, on the same seeded
inputs: the table within 1e-6 relative, the ADC within 1e-5 relative, and
the ADC against ||q - decode(c)||^2 within 1e-4 relative (the identity of
every scan)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rii_tpu.ops import decode as JD
from rii_tpu_torch.ops import decode as TD


def _inputs(m, ks, ds, n=400, seed=2):
    rng = np.random.RandomState(seed)
    cw = rng.normal(0, 1, (m, ks, ds)).astype(np.float32)
    codes = rng.randint(0, ks, (n, m)).astype(np.uint8)
    q = rng.normal(0, 1, m * ds).astype(np.float32)
    return q, codes, cw


@pytest.mark.parametrize("m,ks,ds", [(4, 16, 8), (8, 256, 16), (5, 32, 3)])
def test_dtable_matches_rii_tpu(m, ks, ds):
    q, _, cw = _inputs(m, ks, ds)
    dt = TD.dtable(torch.from_numpy(q), torch.from_numpy(cw))
    assert dt.shape == (m, ks) and dt.dtype == torch.float32
    ref = np.asarray(JD.dtable(jnp.asarray(q), jnp.asarray(cw)))
    np.testing.assert_allclose(dt.numpy(), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("m,ks,ds", [(4, 16, 8), (8, 256, 16), (5, 32, 3)])
def test_adc_oracle_matches_rii_tpu_and_the_decoded_l2(m, ks, ds):
    q, codes, cw = _inputs(m, ks, ds)
    adc = TD.adc_oracle(torch.from_numpy(q), torch.from_numpy(codes),
                        torch.from_numpy(cw))
    assert adc.shape == (len(codes),) and adc.dtype == torch.float32
    ref = np.asarray(JD.adc_oracle(jnp.asarray(q), jnp.asarray(codes),
                                   jnp.asarray(cw)))
    np.testing.assert_allclose(adc.numpy(), ref, rtol=1e-5, atol=0)
    dec = TD.onehot_decode(torch.from_numpy(codes), torch.from_numpy(cw)).numpy()
    l2 = ((q[None, :].astype(np.float64) - dec) ** 2).sum(-1)
    np.testing.assert_allclose(adc.numpy(), l2, rtol=1e-4, atol=0)


def test_adc_oracle_takes_integer_codes_of_any_width():
    q, codes, cw = _inputs(4, 16, 8)
    a = TD.adc_oracle(torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(cw))
    b = TD.adc_oracle(torch.from_numpy(q), torch.from_numpy(codes.astype(np.int64)),
                      torch.from_numpy(cw))
    assert torch.equal(a, b)
