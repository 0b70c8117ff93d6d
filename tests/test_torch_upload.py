"""The engine's query upload (``Rii._upload_queries``): the batch padded to
its power-of-two bucket with copies of row 0, on the engine's device.

On the CPU: the padding against ``_pad_queries``, answers bit-equal to an
upload through ``_pad_queries`` and ``torch.tensor`` on the linear and IVF
routes (plain and kernel routes), and a pickled engine. Marked ``gpu`` (skip
without a card): the page-locked staging buffer across batches that grow and
shrink, a copy still pending when the next batch arrives, four threads at
once, and the ``upload_staged`` counter. This file imports no JAX, so the
card's machine runs it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_upload.py
"""

import pickle
import threading
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rii_tpu_torch.utils.profiling as P
from rii_tpu_torch import PQ, Rii
from rii_tpu_torch.rii import _pad_queries, _QueryStaging
from rii_tpu_torch.store import _pow2_at_least


def _build(device, force_kernel_routing=False, n=40000, d=16):
    """N=40,000 over 400 lists: a batch of up to 8 queries at L=L0 stays on
    the IVF windows, and L=N sends it to the linear scan."""
    X = np.random.RandomState(0).random((n, d)).astype(np.float32)
    e = Rii(PQ(M=4, Ks=16, device=device).fit(X[:500], iter=2))
    e.force_kernel_routing = force_kernel_routing
    e.add_configure(X, nlist=400, iter=2)
    return e, X


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "kernel_routes"])
def engine(request):
    return _build("cpu", force_kernel_routing=request.param)


def _parent_upload(self, queries, lo=1):
    """The upload before the staging buffer: a fresh padded array, then a
    copy."""
    qp, qn = _pad_queries(queries, lo=lo)
    return torch.tensor(qp, device=self.device), qn


def _roots(fn):
    """The roots that ``fn`` records under a CPU profiler."""
    before = {s.id for s in P.spans()}
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return [s for s in P.spans() if s.id not in before and s.parent is None]


@pytest.mark.parametrize("lo", [1, 8])
@pytest.mark.parametrize("qn", [1, 7, 8, 9, 1000, 1024])
def test_upload_pads_a_row_slice_to_its_bucket(engine, qn, lo):
    e, X = engine
    ring = np.random.RandomState(qn).random((qn + 9, X.shape[1])).astype(
        np.float32)
    q = ring[5:5 + qn]  # a row slice of a larger array, as the harness's
    qd, n = e._upload_queries(q, lo=lo)
    bucket = _pow2_at_least(qn, lo)
    assert n == qn and qd.shape == (bucket, X.shape[1])
    assert qd.dtype == torch.float32 and qd.device == e.device
    out = qd.numpy()
    np.testing.assert_array_equal(out[:qn], q)
    assert (out[qn:] == q[0]).all()
    qp, _ = _pad_queries(q, lo=lo)
    assert out.tobytes() == np.ascontiguousarray(qp).tobytes()
    np.testing.assert_array_equal(ring[5:5 + qn], q)  # the caller's rows


def test_upload_takes_a_read_only_batch_without_a_warning(engine):
    e, X = engine
    q = np.array(X[:9])
    q.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        qd, n = e._upload_queries(q, lo=8)
    qp, _ = _pad_queries(q, lo=8)
    assert n == 9 and qd.numpy().tobytes() == qp.tobytes()


_ROUTES = [("linear", 7), ("linear", 9), ("ivf", 1), ("ivf", 7),
           ("ivf_to_linear", 9)]


@pytest.mark.parametrize("route,qn", _ROUTES)
def test_answers_equal_the_parent_upload(engine, monkeypatch, route, qn):
    e, X = engine
    q = X[np.asarray(e.posting_lists[5][:qn])]
    kw = {"linear": dict(method="linear"),
          "ivf": dict(method="ivf", L=e.L0),
          "ivf_to_linear": dict(method="ivf", L=e.N)}[route]
    [root] = _roots(lambda: e.query_batch(q, topk=10, **kw))
    assert root.attrs["route"] == route
    assert root.attrs["upload_staged"] == 0
    ids, dists = e.query_batch(q, topk=10, **kw)
    with monkeypatch.context() as m:
        m.setattr(Rii, "_upload_queries", _parent_upload)
        ids_p, dists_p = e.query_batch(q, topk=10, **kw)
    assert ids.tobytes() == ids_p.tobytes()
    assert dists.tobytes() == dists_p.tobytes()


def test_a_pickled_engine_answers_the_same(engine):
    e, X = engine
    q = X[100:107]
    before = [e.query_batch(q, topk=10, **kw)
              for kw in (dict(method="linear"), dict(method="ivf", L=e.L0))]
    e2 = pickle.loads(pickle.dumps(e))
    assert isinstance(e2._staging, _QueryStaging)
    assert e2._staging is not e._staging and e2._staging._host is None
    after = [e2.query_batch(q, topk=10, **kw)
             for kw in (dict(method="linear"), dict(method="ivf", L=e2.L0))]
    for (i, d), (i2, d2) in zip(before, after):
        assert i.tobytes() == i2.tobytes() and d.tobytes() == d2.tobytes()


# -- on the card ---------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the staging buffer is page-locked "
                    "host memory for a card's copies")
    return _build("cuda", d=64)


def _fresh(e):
    """An engine over the same state, with its own cache and buffer."""
    return pickle.loads(pickle.dumps(e))


def _same(a, b):
    return all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


@pytest.mark.gpu
def test_growing_and_shrinking_batches_answer_as_a_fresh_engine(cuda_engine):
    e, X = cuda_engine
    caller = np.empty((1100, X.shape[1]), np.float32)
    for k, qn in enumerate([1, 1000, 7, 1024, 9, 300, 8, 1000]):
        rows = X[k * 997 % 30000:][:qn]
        kw = dict(method="linear") if k % 2 else dict(method="ivf", L=e.L0)
        caller[:qn] = rows
        got = e.query_batch(caller[:qn], topk=10, **kw)
        caller[:] = np.nan  # the caller reuses its array at once
        want = _fresh(e).query_batch(rows.copy(), topk=10, **kw)
        assert _same(got, want), (qn, kw)
    assert e._staging._host.numel() == 1024 * X.shape[1]


@pytest.mark.gpu
def test_a_pending_copy_is_never_overwritten(cuda_engine):
    """The device sleeps ahead of the first copy, so it is still pending
    when the next batch is filled: the fill waits for the copy's event."""
    e, X = cuda_engine
    e = _fresh(e)
    q1, q2, q3 = X[:7], X[7:14], X[14:40]
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 30)  # about half a second of device time
    a, _ = e._upload_queries(q1, lo=8)
    # the host did not wait for the copy: the sleep still runs
    assert not torch.cuda.current_stream().query()
    host = e._staging._host.data_ptr()
    b, _ = e._upload_queries(q2, lo=8)  # the same bucket and buffer
    assert e._staging._host.data_ptr() == host
    c, _ = e._upload_queries(q3, lo=8)  # a larger bucket grows the buffer
    assert e._staging._host.numel() == 32 * X.shape[1]
    for t, q in ((a, q1), (b, q2), (c, q3)):
        qp, _ = _pad_queries(q, lo=8)
        assert t.cpu().numpy().tobytes() == np.ascontiguousarray(qp).tobytes()


@pytest.mark.gpu
def test_four_threads_answer_as_serial_calls(cuda_engine):
    e, X = cuda_engine
    e = _fresh(e)
    jobs = [(X[200 * k:200 * k + qn], kw) for k, (qn, kw) in enumerate(
        [(7, dict(method="ivf", L=e.L0)), (1000, dict(method="linear")),
         (9, dict(method="linear")), (64, dict(method="ivf", L=e.L0))])]
    serial = [e.query_batch(q, topk=10, **kw) for q, kw in jobs]
    got = [[] for _ in jobs]
    errors = []

    def worker(j):
        try:
            q, kw = jobs[j]
            for _ in range(12):
                got[j].append(e.query_batch(q, topk=10, **kw))
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(j,)) for j in
               range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for j, answers in enumerate(got):
        assert len(answers) == 12
        assert all(_same(a, serial[j]) for a in answers), j


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(method="linear"),
                                dict(method="ivf", L=100)],
                         ids=["linear", "ivf"])
def test_upload_staged_reads_one_under_a_profiler(cuda_engine, kw):
    e, X = cuda_engine
    roots = _roots(lambda: [e.query_batch(X[:k], topk=10, **kw)
                            for k in (1, 7)])
    assert len(roots) == 2
    assert all(r.attrs["upload_staged"] == 1 for r in roots)
