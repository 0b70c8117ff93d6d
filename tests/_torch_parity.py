"""Helpers shared by the parity tests of ``rii_tpu_torch`` against ``rii_tpu``."""

import numpy as np

NEAR_TIE_RTOL = 1e-5  # two argmin candidates closer than this are a near-tie


def decode64(codewords, codes):
    """float64 reconstruction of (N, M) codes."""
    cw = np.asarray(codewords, np.float64)
    m = cw.shape[0]
    return cw[np.arange(m)[None, :], codes.astype(np.int64)].reshape(len(codes), -1)


def assert_assignments_equal_but_near_ties(codewords, codes, centers, a, b):
    """Assignments a and b agree, except at rows where the two chosen
    centers are at distances within NEAR_TIE_RTOL of each other (float64)."""
    diff = np.nonzero(a != b)[0]
    if diff.size == 0:
        return
    x = decode64(codewords, codes[diff])
    c = decode64(codewords, centers)
    da = ((x - c[a[diff]]) ** 2).sum(1)
    db = ((x - c[b[diff]]) ** 2).sum(1)
    rel = np.abs(da - db) / np.maximum(np.abs(da), 1e-30)
    assert (rel < NEAR_TIE_RTOL).all(), (diff, rel)


def assert_ranked_ids_match(ids_a, d_a, ids_b, d_b, rtol):
    """Distances agree to rtol per rank; ids agree per rank except where
    the distance at that rank is tied (the other id then sits at a rank
    whose distance is equal within rtol)."""
    np.testing.assert_allclose(d_a, d_b, rtol=rtol, atol=rtol)
    for r in range(ids_a.shape[0]):
        for k in np.nonzero(ids_a[r] != ids_b[r])[0]:
            ties = np.isclose(d_b[r], d_a[r, k], rtol=rtol, atol=rtol)
            assert ids_a[r, k] in ids_b[r][ties], (r, k, ids_a[r], ids_b[r])


def unpack(keys, low):
    """numpy twin of the packed-key unpack: (values, lanes)."""
    bits = np.asarray(keys, np.float32).view(np.int32)
    v = (bits & ~low).view(np.float32)
    return np.where(v >= np.float32(2.9e38), np.inf, v), bits & low


def assert_keys_match(v_a, l_a, v_b, l_b, rtol=1e-5, atol=1e-5, agree=0.99):
    """Unpacked key values agree to rtol + atol, +inf where the other is;
    slots agree on at least ``agree`` of the tiles, and where they do not the
    values still agree (a near-tie)."""
    fin = np.isfinite(v_b)
    np.testing.assert_array_equal(np.isfinite(v_a), fin)
    np.testing.assert_allclose(v_a[fin], v_b[fin], rtol=rtol, atol=atol)
    assert (l_a[fin] == l_b[fin]).mean() >= agree


def port_engine(je, **attrs):
    """A CPU port engine over a JAX engine's arrays (codewords, codes,
    coarse centers, assignments and, for OPQ, the rotation), so that both
    hold the same state; ``attrs`` set on it (scan_mode, topk_recall, ...)."""
    from rii_tpu_torch.utils.convert import engine_from_arrays

    rot = getattr(je.fine_quantizer, "rotation_matrix", None)
    te = engine_from_arrays(je.codewords, je.codes, je.coarse_centers,
                            je._assignments(), device="cpu",
                            rotation_matrix=rot)
    for k, v in attrs.items():
        setattr(te, k, v)
    return te
