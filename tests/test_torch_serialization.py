"""Checkpoints in the port (rii_tpu_torch.utils.serialization), the
engine's pickle and print_params, against rii_tpu's.

The cases of tests/test_serialization.py on the port, then the format held
across the packages: a directory saved by either loads in the other, the
arrays of both packages' directories of one state are equal file for file,
and v2 directories are adopted at the first query. Answers within one
package are compared exactly; across packages in exact mode, ids per rank
(ties aside) and distances within 3e-6 relative, as
tests/test_torch_engine.py holds the engines."""

import io
import json
import os
import pickle
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import rii_tpu
import rii_tpu.utils.serialization as jser
from rii_tpu_torch import OPQ, PQ, Rii
from rii_tpu_torch.utils.convert import engine_from_arrays
from rii_tpu_torch.utils.serialization import load_index, save_index

from _torch_parity import assert_ranked_ids_match

EXACT_RTOL = 3e-6


def _data(n=1000, d=40, seed=123):
    return np.random.RandomState(seed).random((n, d)).astype(np.float32)


def _engine(X, nlist, codec=PQ):
    e = Rii(codec(M=4, Ks=20, device="cpu").fit(X, iter=3))
    e.add_configure(vecs=X, nlist=nlist)
    return e


def test_save_load_roundtrip(tmp_path):
    X = _data()
    e1 = _engine(X, 20)
    save_index(e1, str(tmp_path / "idx"))
    e2 = load_index(str(tmp_path / "idx"), device="cpu")
    assert (e1.M, e1.Ks, e1.N, e1.nlist) == (e2.M, e2.Ks, e2.N, e2.nlist)
    assert e2.device == torch.device("cpu")
    np.testing.assert_array_equal(e1.codes, e2.codes)
    np.testing.assert_array_equal(e1.coarse_centers, e2.coarse_centers)
    assert e1.posting_lists == e2.posting_lists
    np.testing.assert_array_equal(np.poly1d(e1.threshold).coeffs,
                                  np.poly1d(e2.threshold).coeffs)
    ids1, d1 = e1.query(X[0], topk=5)
    ids2, d2 = e2.query(X[0], topk=5)
    np.testing.assert_array_equal(ids1, ids2)
    np.testing.assert_array_equal(d1, d2)
    e2.add(X)  # a restored engine stays mutable
    assert e2.N == 2 * e1.N


def test_save_load_opq(tmp_path):
    X = _data()
    e1 = _engine(X, 10, codec=OPQ)
    save_index(e1, str(tmp_path / "idx"))
    e2 = load_index(str(tmp_path / "idx"), device="cpu")
    assert isinstance(e2.fine_quantizer, OPQ)
    np.testing.assert_array_equal(e1.fine_quantizer.rotation_matrix,
                                  e2.fine_quantizer.rotation_matrix)
    ids1, d1 = e1.query(X[3], topk=5)
    ids2, d2 = e2.query(X[3], topk=5)
    np.testing.assert_array_equal(ids1, ids2)
    np.testing.assert_array_equal(d1, d2)


def test_save_load_unbuilt(tmp_path):
    X = _data()
    e1 = Rii(PQ(M=4, Ks=20, device="cpu").fit(X, iter=3))
    save_index(e1, str(tmp_path / "empty"))
    e2 = load_index(str(tmp_path / "empty"), device="cpu")
    assert e2.N == 0 and e2.nlist == 0 and e2.threshold is None
    e2.add_configure(X, nlist=10)
    assert e2.N == 1000


def _cache_arrays(stores):
    return {k: v.float().numpy() for st in stores for k, v in st.tensors().items()
            if k in ("order_g", "norms_g", "vlen_g", "codes_g", "codes_flat",
                     "norms_flat", "centers_norms_v", "decoded_g", "decoded_g_i8",
                     "i8_scales_g")}


@pytest.mark.parametrize("windows", ["pq", "bf16", "int8"])
def test_v2_layout_adoption_identical_cache(tmp_path, windows):
    """The adopted layout reproduces the rebuilt one exactly: the same
    cache tensors (the int8 windows' column scales see the padding slots
    too), the same answers. bf16 and int8 windows take the kernel routes
    through the twins."""
    X = _data(4000, 40)
    e1 = _engine(X, 30)
    e1.scan_mode = windows
    e1.force_kernel_routing = windows != "pq"
    q = X[:8]
    ids1, d1 = e1.query_batch(q, topk=5, method="ivf", L=400)
    assert e1.last_cache_build_stats["adopted_layout"] is False
    assert e1._ensure_cache()[1].tier == windows
    save_index(e1, str(tmp_path / "idx"))
    e2 = load_index(str(tmp_path / "idx"), device="cpu")
    e2.force_kernel_routing = e1.force_kernel_routing
    assert e2.scan_mode == windows
    assert e2._layout_v is not None and e2._norms_cache is not None
    ids2, d2 = e2.query_batch(q, topk=5, method="ivf", L=400)
    # one-shot: consumed by the first cache build
    assert e2._layout_v is None and e2._norms_cache is None
    assert e2.last_cache_build_stats["adopted_layout"] is True
    np.testing.assert_array_equal(ids1, ids2)
    np.testing.assert_array_equal(d1, d2)
    st1, st2 = e1._ensure_cache(), e2._ensure_cache()
    a1, a2 = _cache_arrays(st1), _cache_arrays(st2)
    assert sorted(a1) == sorted(a2) and "order_g" in a1
    for key in a1:
        np.testing.assert_array_equal(a1[key], a2[key])
    (lin1, win1), (lin2, win2) = st1, st2
    assert lin1.cap == lin2.cap
    for key in ("cap_v", "nlist_v", "nlist_v_pad", "tier"):
        assert getattr(win1, key) == getattr(win2, key), key
    np.testing.assert_array_equal(win1.v_counts, win2.v_counts)
    np.testing.assert_array_equal(win1.v_capacity, win2.v_capacity)


def test_v2_adoption_invalidated_by_mutation(tmp_path):
    """Mutations after the load never see stale adopted state."""
    X = _data(3000, 40)
    e1 = _engine(X, 25)
    save_index(e1, str(tmp_path / "idx"))

    # a reconfigure at the same (n, nlist) changes the assignments
    e2 = load_index(str(tmp_path / "idx"), device="cpu")
    e2.reconfigure(nlist=25, iter=3)
    assert e2._layout_v is None
    ids, d = e2.query_batch(X[:4], topk=5, method="ivf", L=300)
    assert np.isfinite(d).all()
    assert e2.last_cache_build_stats["adopted_layout"] is False

    # an add before the first query changes n: the n-guard skips adoption
    e3 = load_index(str(tmp_path / "idx"), device="cpu")
    e3.add_codes(e3.fine_quantizer.encode(X[:100]))
    ids3, d3 = e3.query_batch(X[:4], topk=5, method="ivf", L=300)
    assert np.isfinite(d3).all() and e3.N == 3100
    assert e3.last_cache_build_stats["adopted_layout"] is False
    assert e3._layout_v is None and e3._norms_cache is None

    # clear drops everything
    e4 = load_index(str(tmp_path / "idx"), device="cpu")
    e4.clear()
    assert e4._layout_v is None and e4._norms_cache is None


def test_v1_manifest_still_loads(tmp_path):
    X = _data(1500, 40)
    e1 = _engine(X, 15)
    path = str(tmp_path / "idx")
    save_index(e1, path, layout=False)
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        m = json.load(f)
    m["format"] = "rii_tpu.index.v1"
    m.pop("layout", None)
    m.pop("cap_reserve", None)
    with open(mpath, "w") as f:
        json.dump(m, f)
    e2 = load_index(path, device="cpu")
    assert e2._layout_v is None
    ids1, _ = e1.query(X[0], topk=5)
    ids2, _ = e2.query(X[0], topk=5)
    np.testing.assert_array_equal(ids1, ids2)
    assert e2.last_cache_build_stats["adopted_layout"] is False


@pytest.fixture(scope="module")
def pair():
    """A rii_tpu engine and the port's engine over its arrays, exact mode,
    with a reserve that makes the layout's headroom differ from 0.125."""
    X = _data(4000, 40, seed=5)
    jpq = rii_tpu.PQ(M=4, Ks=20).fit(X[:1000], iter=3)
    je = rii_tpu.Rii(jpq)
    je.topk_recall = None
    je.reserve(4600)
    je.add_configure(X, nlist=30, iter=3)
    te = engine_from_arrays(je.codewords, je.codes, je.coarse_centers,
                            je._assignments(), device="cpu")
    te.topk_recall = None
    te.reserve(4600)
    te.threshold = je.threshold
    return X, je, te


def _queries(X):
    return (X[:8] + np.random.RandomState(6).normal(0, 0.01, (8, X.shape[1]))
            ).astype(np.float32)


def test_directories_equal_across_packages(tmp_path, pair):
    """Both packages write the same manifest and the same arrays for one
    state."""
    _, je, te = pair
    jser.save_index(je, str(tmp_path / "j"))
    save_index(te, str(tmp_path / "t"))
    mj = json.load(open(tmp_path / "j" / "manifest.json"))
    mt = json.load(open(tmp_path / "t" / "manifest.json"))
    assert mj == mt
    assert mt["layout"]["headroom"] != 0.125
    for name in mj["arrays"]:
        a = np.load(tmp_path / "j" / f"{name}.npy")
        b = np.load(tmp_path / "t" / f"{name}.npy")
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("method", ["linear", "ivf"])
def test_rii_tpu_directory_loads_in_the_port(tmp_path, pair, method):
    X, je, te = pair
    jser.save_index(je, str(tmp_path / "j"))
    t2 = load_index(str(tmp_path / "j"), device="cpu")
    t2.topk_recall = None
    q = _queries(X)
    i2, d2 = t2.query_batch(q, topk=10, method=method, L=400)
    assert t2.last_cache_build_stats["adopted_layout"] is True
    it, dt = te.query_batch(q, topk=10, method=method, L=400)
    np.testing.assert_array_equal(i2, it)
    np.testing.assert_array_equal(d2, dt)
    ij, dj = je.query_batch(q, topk=10, method=method, L=400)
    assert_ranked_ids_match(i2, d2, ij, dj, EXACT_RTOL)


@pytest.mark.parametrize("method", ["linear", "ivf"])
def test_port_directory_loads_in_rii_tpu(tmp_path, pair, method):
    X, je, te = pair
    save_index(te, str(tmp_path / "t"))
    j2 = jser.load_index(str(tmp_path / "t"))
    j2.topk_recall = None
    q = _queries(X)
    i2, d2 = j2.query_batch(q, topk=10, method=method, L=400)
    assert j2.last_cache_build_stats["adopted_layout"] is True
    ij, dj = je.query_batch(q, topk=10, method=method, L=400)
    np.testing.assert_array_equal(i2, ij)
    np.testing.assert_array_equal(d2, dj)
    dcj, win = j2._ensure_cache(), te._ensure_cache()[1]
    np.testing.assert_array_equal(np.asarray(dcj["order_g"]),
                                  win.order_g.numpy())
    it, dt = te.query_batch(q, topk=10, method=method, L=400)
    assert_ranked_ids_match(it, dt, i2, d2, EXACT_RTOL)


def test_opq_directories_cross_load(tmp_path):
    X = _data(2000, 32, seed=9)
    # M=8, so that no two rows share a code: two equal codes tie exactly,
    # and a tie at the top-k boundary has no rank order to compare
    jopq = rii_tpu.OPQ(M=8, Ks=16).fit(X[:800], iter=3, rotation_iter=2)
    je = rii_tpu.Rii(jopq)
    je.topk_recall = None
    je.add_configure(X, nlist=20, iter=3)
    jser.save_index(je, str(tmp_path / "j"))
    t2 = load_index(str(tmp_path / "j"), device="cpu")
    assert isinstance(t2.fine_quantizer, OPQ)
    t2.topk_recall = None
    q = _queries(X)
    i2, d2 = t2.query_batch(q, topk=10, method="ivf", L=300)
    assert t2.last_cache_build_stats["adopted_layout"] is True
    te = engine_from_arrays(je.codewords, je.codes, je.coarse_centers,
                            je._assignments(), device="cpu",
                            rotation_matrix=jopq.rotation_matrix)
    te.topk_recall = None
    it, dt = te.query_batch(q, topk=10, method="ivf", L=300)
    np.testing.assert_array_equal(i2, it)
    np.testing.assert_array_equal(d2, dt)
    # across the packages on the same rotated queries (each package's
    # rotation rounds in its own order, which can reorder a near-tie)
    qr = jopq.rotate(q)
    for r in range(len(q)):
        i_t, d_t = t2.query_ivf(qr[r], 10, None, 300)
        i_j, d_j = je.query_ivf(qr[r], 10, None, 300)
        assert_ranked_ids_match(i_t[None], d_t[None], i_j[None], d_j[None],
                                EXACT_RTOL)
    save_index(t2, str(tmp_path / "t"))
    j3 = jser.load_index(str(tmp_path / "t"))
    assert isinstance(j3.fine_quantizer, rii_tpu.OPQ)
    np.testing.assert_array_equal(j3.fine_quantizer.rotation_matrix,
                                  jopq.rotation_matrix)


def test_mmap_load_then_add(tmp_path):
    X = _data(2000, 40)
    e1 = _engine(X, 20)
    path = str(tmp_path / "idx")
    save_index(e1, path)
    before = np.load(os.path.join(path, "codes.npy")).copy()
    e2 = load_index(path, mmap=True, device="cpu")
    assert isinstance(e2._code_chunks[0], np.memmap)
    ids, _ = e2.query(X[1], topk=3)
    assert ids[0] == e1.query(X[1], topk=3)[0][0]
    e2.add(X[:50])
    assert e2.N == 2050
    ids, _ = e2.query_batch(X[:4], topk=3, method="linear")
    assert e2.codes.shape == (2050, 4)
    np.testing.assert_array_equal(e2.codes[:2000], before)
    np.testing.assert_array_equal(np.load(os.path.join(path, "codes.npy")), before)


def test_pickle_round_trip():
    X = _data(2000, 40)
    e1 = _engine(X, 20)
    e1.add(X[:100])  # a second chunk: the pickle consolidates
    ids1, d1 = e1.query_batch(X[:8], topk=5)
    e2 = pickle.loads(pickle.dumps(e1))
    assert e2._stores is None and e2.device == e1.device
    assert e2.fine_quantizer == e1.fine_quantizer
    assert e2.fine_quantizer.device == e1.fine_quantizer.device
    ids2, d2 = e2.query_batch(X[:8], topk=5)
    np.testing.assert_array_equal(ids1, ids2)
    np.testing.assert_array_equal(d1, d2)
    assert e2.last_cache_build_stats["adopted_layout"] is False
    e2.add(X[:10])  # the locks are new and work
    assert e2.N == 2110 and e1.N == 2100


def test_unpickled_card_engine_raises_at_first_use_without_a_card():
    """An engine pickled on the card keeps its device: where there is no
    card it raises at its first query, and does not move to the CPU."""
    X = _data(1000, 40)
    e = _engine(X, 10)
    state = e.__getstate__()
    state["device"] = torch.device("cuda", 0)  # a card engine's, index fixed
    e2 = Rii.__new__(Rii)
    e2.__setstate__(state)
    e3 = pickle.loads(pickle.dumps(e2))
    assert e3.device == torch.device("cuda", 0)
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the engine would run there")
    with pytest.raises((RuntimeError, AssertionError)):
        e3.query(X[0], topk=3)


def test_print_params_matches_rii_tpu(pair):
    _, je, te = pair
    je.query(_queries(pair[0])[0], topk=3)
    te.query(_queries(pair[0])[0], topk=3)
    outs = []
    for e in (je, te):
        buf = io.StringIO()
        with redirect_stdout(buf):
            e.print_params()
        outs.append(buf.getvalue().splitlines())
    lj, lt = outs
    assert len(lj) == len(lt) > 10
    for a, b in zip(lj, lt):
        if a.startswith("fine_quantizer:"):
            assert b.startswith("fine_quantizer: PQ(")
            continue
        assert a == b
