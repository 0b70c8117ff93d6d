"""The port's sharded scans (``rii_tpu_torch.parallel``) against
``rii_tpu.parallel`` and against the port's single-device scans.

The JAX side runs on ``tests/conftest.py``'s eight CPU devices, the port on
an eight-shard CPU mesh (eight placements of the CPU). Both start from the
same codewords and codes. N=2048-4096, D=32, M=4, Ks=16-32. Exact-mode
distances agree to 1e-5 relative, ids per rank except at ties.

The JAX package is imported inside the tests that use it, so that the
module also loads where there is no JAX: its ``gpu`` case runs on the card
with ``python -m pytest --noconftest -m gpu tests/test_torch_sharded.py``."""

import numpy as np
import pytest
import torch

from rii_tpu_torch import PQ, Rii
from rii_tpu_torch.models.ivf import code_norms_np
from rii_tpu_torch.ops.scan import linear_scan_topk
from rii_tpu_torch.parallel import (
    ShardedRii,
    init_distributed,
    make_mesh,
    make_mesh_hc,
    make_sharded_linear_scan,
    make_sharded_pqkmeans_step,
    shard_database,
)

from _torch_parity import (assert_assignments_equal_but_near_ties,
                           assert_ranked_ids_match, port_engine)

RTOL = 1e-5


def _jax():
    """(jax.numpy, rii_tpu, rii_tpu.parallel)."""
    import jax.numpy as jnp
    import rii_tpu
    import rii_tpu.parallel as jpar
    return jnp, rii_tpu, jpar


def _mesh():
    return make_mesh(8, device="cpu")


def _index(n=2048, d=32, m=4, ks=16):
    _, rii_tpu, _ = _jax()
    rng = np.random.RandomState(7)
    x = rng.random((n, d)).astype(np.float32)
    pq = rii_tpu.PQ(M=m, Ks=ks).fit(x)
    codes = pq.encode(x)
    norms = code_norms_np(pq.codewords, codes)
    return x, pq, codes, norms


def _ivf_pair(seed, scan_mode="bf16", topk_recall=None):
    """A JAX engine (N=4096, D=32, M=4, Ks=16, nlist=48) and the port's
    engine over its arrays."""
    _, rii_tpu, _ = _jax()
    rng = np.random.RandomState(seed)
    x = rng.random((4096, 32)).astype(np.float32)
    je = rii_tpu.Rii(rii_tpu.PQ(M=4, Ks=16).fit(x[:1024], iter=3))
    je.scan_mode = scan_mode
    je.topk_recall = topk_recall
    je.add_configure(x, nlist=48, iter=3)
    te = port_engine(je, scan_mode=scan_mode, topk_recall=topk_recall)
    return je, te, x, rng


def test_mesh_has_8_shards():
    jnp, rii_tpu, jpar = _jax()
    mesh = _mesh()
    assert mesh.shape["data"] == 8 == jpar.make_mesh().shape["data"]
    assert mesh.devices == [torch.device("cpu")] * 8
    assert mesh.local == list(range(8)) and mesh.group is None


def test_mesh_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh_hc(2, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        init_distributed(init_method="tcp://localhost:1", world_size=1, rank=0)


def test_sharded_linear_scan_matches_single_device():
    jnp, rii_tpu, jpar = _jax()
    x, pq, codes, norms = _index()
    topk = 10
    q = x[:16]
    cw = torch.tensor(pq.codewords)
    d_ref, i_ref = linear_scan_topk(torch.tensor(q), torch.tensor(codes),
                                    torch.tensor(norms), cw, topk, block=512)
    mesh = _mesh()
    codes_sh, norms_sh = shard_database(mesh, codes, norms)
    fn = make_sharded_linear_scan(mesh, topk=topk, block=256)
    d_sh, i_sh = fn(torch.tensor(q), codes_sh, norms_sh, cw)
    assert_ranked_ids_match(i_sh.numpy(), d_sh.numpy(), i_ref.numpy(),
                            d_ref.numpy(), rtol=RTOL)
    # against rii_tpu's sharded scan on its eight devices
    jmesh = jpar.make_mesh()
    jc, jn = jpar.shard_database(jmesh, codes, norms)
    jd, ji = jpar.make_sharded_linear_scan(jmesh, topk=topk, block=256)(
        jnp.asarray(q), jc, jn, jnp.asarray(pq.codewords))
    assert_ranked_ids_match(i_sh.numpy(), d_sh.numpy(), np.asarray(ji),
                            np.asarray(jd), rtol=RTOL)
    from rii_tpu.ops.scan import linear_scan_topk as jax_linear_scan_topk
    d_j, i_j = jax_linear_scan_topk(jnp.asarray(q), jnp.asarray(codes),
                                    jnp.asarray(norms), jnp.asarray(pq.codewords),
                                    topk=topk, block=512)
    assert_ranked_ids_match(i_sh.numpy(), d_sh.numpy(), np.asarray(i_j),
                            np.asarray(d_j), rtol=RTOL)


def test_sharded_pqkmeans_step_matches_reference_impl():
    jnp, rii_tpu, jpar = _jax()
    x, pq, codes, norms = _index()
    k = 16
    codes_i = codes.astype(np.int32)
    weights = np.ones(len(codes), np.float32)
    centers0 = codes_i[np.random.RandomState(0).permutation(len(codes))[:k]]

    mesh = _mesh()
    step = make_sharded_pqkmeans_step(mesh, k=k)
    c_sh, w_sh = shard_database(mesh, codes_i, weights)
    new, assigns = step(c_sh, w_sh, torch.tensor(centers0), torch.tensor(pq.codewords))
    a_port = torch.cat(assigns).numpy()

    jstep = jpar.make_sharded_pqkmeans_step(jpar.make_mesh(), k=k)
    new_j, a_j = jstep(jnp.asarray(codes_i), jnp.asarray(weights),
                       jnp.asarray(centers0), jnp.asarray(pq.codewords))
    assert_assignments_equal_but_near_ties(pq.codewords, codes, centers0,
                                           a_port, np.asarray(a_j))
    assert (new.numpy() == np.asarray(new_j)).mean() > 0.95

    # the single-device oracle: one full step in the decoded domain
    from rii_tpu.models.pqkmeans import _assign_blocks, _update_centers
    cw = jnp.asarray(pq.codewords)
    cb = jnp.asarray(codes_i.reshape(-1, 512, codes.shape[1]))
    wb = jnp.asarray(weights.reshape(-1, 512))
    a_ref, _, sums, counts = _assign_blocks(cw, cb, wb, jnp.asarray(centers0), True)
    c_ref = _update_centers(cw, jnp.asarray(centers0), sums, counts)
    assert (a_port == np.asarray(a_ref).reshape(-1)).mean() > 0.99
    assert (new.numpy() == np.asarray(c_ref)).mean() > 0.95


def test_rii_results_consistent_with_sharded_scan():
    """The port engine's linear answers equal the sharded scan's over its
    padded codes."""
    x, pq, codes, norms = _index()
    e = Rii(PQ.from_codewords(pq.codewords, device="cpu"))
    e.topk_recall = None
    e.add_configure(vecs=x, nlist=16)
    q = x[:4]
    ids_e, dists_e = e.query_batch(q, topk=5, method="linear")
    cap = e._ensure_cache()[0].cap
    codes_pad = np.zeros((cap, codes.shape[1]), np.uint8)
    codes_pad[:len(codes)] = e.codes
    norms_pad = np.full(cap, np.inf, np.float32)
    norms_pad[:len(codes)] = code_norms_np(pq.codewords, e.codes)
    mesh = _mesh()
    codes_sh, norms_sh = shard_database(mesh, codes_pad, norms_pad)
    d_sh, i_sh = make_sharded_linear_scan(mesh, topk=5, block=256)(
        torch.tensor(q), codes_sh, norms_sh, torch.tensor(pq.codewords))
    assert_ranked_ids_match(i_sh.numpy(), d_sh.numpy(), ids_e, dists_e, rtol=RTOL)


def test_sharded_ivf_matches_linear_at_full_coverage():
    jnp, rii_tpu, jpar = _jax()
    je, te, x, rng = _ivf_pair(11)
    sr = ShardedRii(te, mesh=_mesh(), use_decoded=True)
    assert sr.windows is not None and sr.tier == "bf16"
    jsr = jpar.ShardedRii(je, use_decoded=True)
    q = x[rng.choice(4096, 8, replace=False)]
    ids_l, d_l = sr.query_batch(q, topk=10)
    ids_i, d_i = sr.query_ivf_batch(q, topk=10, L=4096)
    for a, b in zip(ids_l, ids_i):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_allclose(np.sort(d_i, 1), np.sort(d_l, 1), rtol=RTOL)
    # the linear scans of both packages rescore in float32 below Q=512
    ids_j, d_j = jsr.query_batch(q, topk=10)
    assert_ranked_ids_match(ids_l, d_l, ids_j, d_j, rtol=RTOL)
    ids_ji, _ = jsr.query_ivf_batch(q, topk=10, L=4096)
    for a, b in zip(ids_ji, ids_i):
        assert set(a.tolist()) == set(b.tolist())


def test_sharded_ivf_default_L_contracts():
    jnp, rii_tpu, jpar = _jax()
    je, te, x, rng = _ivf_pair(13)
    sr = ShardedRii(te, mesh=_mesh(), use_decoded=True)
    q = x[rng.choice(4096, 4, replace=False)]
    ids, dists = sr.query_ivf_batch(q, topk=5)
    assert ids.shape == (4, 5) and ids.dtype == np.int64
    assert dists.dtype == np.float64
    assert (np.diff(dists, axis=1) >= 0).all()
    ids_l, d_l = sr.query_batch(q, topk=5)
    assert_ranked_ids_match(ids, dists, ids_l, d_l, rtol=RTOL)
    ids_j, d_j = jpar.ShardedRii(je, use_decoded=True).query_ivf_batch(q, topk=5)
    np.testing.assert_array_equal(ids, ids_j)
    for row in ids:
        row = row[row >= 0]
        assert len(set(row.tolist())) == len(row)


def test_sharded_rescore_distances_are_exact_adc():
    """Below Q=512 each shard rescores its candidates in float32 ADC, so
    the merged distances are the exact ADC of the returned ids."""
    from rii_tpu.utils.oracle import adc_np, dtable_np

    x, pq, codes, _ = _index()
    e = Rii(PQ.from_codewords(pq.codewords, device="cpu"))
    e.scan_mode = "bf16"
    e.add_configure(vecs=x, nlist=16)
    sr = ShardedRii(e, mesh=_mesh(), use_decoded=True)
    assert sr.linear[0][0].form == "decoded_flat"
    q = x[:6]
    ids, dists = sr.query_batch(q, topk=5)
    for i in range(len(q)):
        dt = dtable_np(q[i], pq.codewords)
        valid = ids[i] >= 0
        ref = np.array([adc_np(dt, codes[j:j + 1])[0] for j in ids[i][valid]])
        np.testing.assert_allclose(dists[i][valid], ref, rtol=2e-5, atol=1e-5)


@pytest.mark.gpu
def test_four_shard_cuda_mesh_matches_cuda_engine():
    """Four shards on one card (kernels A and B) answer as the card's
    single-device engine: ids per rank but at ties, distances within 1e-5
    relative (both rescore in float32 below Q=512)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.RandomState(3)
    x = rng.random((20000, 128)).astype(np.float32)
    e = Rii(PQ(M=16, Ks=256, device="cuda").fit(x[:5000], iter=5))
    e.scan_mode = "bf16"
    e.add_configure(x, nlist=64)
    sr = ShardedRii(e, mesh=make_mesh(4, device="cuda"), use_decoded=True)
    assert sr.linear[0][0].form == "decoded_t" and sr.tier == "bf16"
    q = (x[:32] + rng.normal(0, 0.01, (32, 128))).astype(np.float32)
    ids_s, d_s = sr.query_batch(q, topk=10)
    ids_e, d_e = e.query_batch(q, topk=10, method="linear")
    assert_ranked_ids_match(ids_s, d_s, ids_e, d_e, rtol=RTOL)
    ids_s, d_s = sr.query_ivf_batch(q, topk=10, L=2000)
    ids_e, d_e = e.query_batch(q, topk=10, L=2000, method="ivf")
    assert_ranked_ids_match(ids_s, d_s, ids_e, d_e, rtol=RTOL)
