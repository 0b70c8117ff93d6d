"""The port's sharded engine across processes (``torch.distributed``): the
counterpart of ``test_multiprocess.py``, on the CPU over gloo (two processes
of four shards, and four of one), and across cards over NCCL (``gpu``:
one process a card, two shards each).

Each worker imports only ``rii_tpu_torch`` and numpy (``jax`` is blocked in
it), builds the same engine state, and wraps it on a mesh that spans the
processes, so each holds and ingests only its own shards. The workers run
linear, IVF (on the window scan) and subset queries, a delta add, and the
distributed reconfigure, bit-identical to the single-device build, on a 1-D
mesh and on a 2-D (hosts, chips) mesh whose host axis is the processes; the
answers equal those of the same mesh held by one process. Every wait has
its own time limit, and the workers are killed on failure. The ``gpu`` case
skips with fewer than two cards; on a machine with them:

    python -m pytest --noconftest -m gpu tests/test_torch_multiprocess.py
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

_WORKER = r'''
import os, sys
sys.modules["jax"] = None  # the port must not need jax
import numpy as np
pid, nproc, port, repo = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
device, spp = sys.argv[5], int(sys.argv[6])  # "cpu" or "cuda"; shards a process
sys.path.insert(0, repo)
import torch
if device == "cpu":
    torch.set_num_threads(2)
from rii_tpu_torch import PQ, Rii
from rii_tpu_torch.parallel import (ShardedRii, init_distributed, make_mesh,
                                    make_mesh_hc)
from rii_tpu_torch.parallel.mesh import Mesh

rank, world = init_distributed(init_method="tcp://localhost:" + port,
                               world_size=nproc, rank=pid, device=device)
assert (rank, world) == (pid, nproc)
assert init_distributed(device=device) == (rank, world)  # already up
try:  # the group is up with the other device type's backend
    init_distributed(device="cuda" if device == "cpu" else "cpu")
    raise SystemExit("a group up with another backend was taken")
except ValueError:
    pass
here = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
        else torch.device("cpu"))

# 128 separated clusters of 256 rows in random order: IVF at L=100 runs the
# window scan (its union stays under half the capacity)
rng = np.random.RandomState(5)
centers = rng.normal(0, 1, (128, 32)).astype(np.float32)
X = np.repeat(centers, 256, axis=0) + 0.3 * rng.normal(0, 1, (32768, 32))
X = np.ascontiguousarray(X[rng.permutation(32768)], np.float32)
n = len(X)
# the codec is fitted on the CPU (the same codewords in every process) and
# used on the device
pq = PQ.from_codewords(PQ(M=8, Ks=64, device="cpu").fit(X[:4096], iter=3).codewords,
                       device=device)
e = Rii(pq)
e.add_configure(X, nlist=128, iter=3)
nshards = nproc * spp

def single(engine, shape=(nshards,), axes=("data",)):
    """The same mesh held by this process alone."""
    return ShardedRii(engine, mesh=Mesh([here] * nshards, axes, shape))

mesh = make_mesh(nshards, device=device)
assert mesh.world == nproc and mesh.local == list(range(spp * pid, spp * pid + spp))
assert mesh.devices == [here] * spp
sr = ShardedRii(e, mesh=mesh)
# per-rank ingestion: this process holds its own shards only
assert len(sr.codes) == spp and sum(len(c) for c in sr.codes) == sr.cap // nproc
ref = single(e)
q = np.ascontiguousarray(X[:8] + 0.01, np.float32)
tids = np.sort(rng.choice(n, 5000, replace=False)).astype(np.int64)

def same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])

def same_but_ties(a, b, rtol=1e-6):
    """Distances per rank; ids per rank but where the distance ties (a
    refresh after an add may size the shards anew, and tied rows then
    merge in another order)."""
    np.testing.assert_allclose(a[1], b[1], rtol=rtol)
    for r, k in zip(*np.nonzero(a[0] != b[0])):
        tied = np.isclose(b[1][r], a[1][r, k], rtol=rtol)
        assert a[0][r, k] in b[0][r][tied] or tied[-1], (r, k, a[0][r], b[0][r])

lin = sr.query_batch(q, topk=5)
same(lin, ref.query_batch(q, topk=5))
# rows of one cluster often share a code, and such ties run past rank 5:
# the single-device engine's distances, not its ids among the ties
np.testing.assert_allclose(lin[1], e.query_batch(q, topk=5, method="linear")[1],
                           rtol=1e-5)
iv = sr.ivf
assert 2 * 64 * iv["cap_v"] < sr.cap  # IVF below scans windows
same(sr.query_ivf_batch(q, topk=5, L=100), ref.query_ivf_batch(q, topk=5, L=100))
sub = sr.query_batch(q, topk=5, target_ids=tids)
same(sub, ref.query_batch(q, topk=5, target_ids=tids))
assert np.isin(sub[0], tids).all()
same(sr.query_ivf_batch(q, topk=5, L=100, target_ids=tids),
     ref.query_ivf_batch(q, topk=5, L=100, target_ids=tids))

# O(batch) delta add across processes: each process places the rows its
# shards own, in place; the new rows are found
held = [c.data_ptr() for c in sr.codes + sr.ivf["codes_g"]]
# new rows away from the old ones, so that the nearest row of each is new
X2 = (4 + rng.random((128, 32))).astype(np.float32)
sr.add(X2, update_posting_lists=True)
assert sr._n_dev == n + 128 and sr._engine_version == e._version
assert [c.data_ptr() for c in sr.codes + sr.ivf["codes_g"]] == held, "rebuilt"
ids_n, _ = sr.query_batch(X2[:4], topk=1)
assert (ids_n[:, 0] >= n).all()
fresh = single(e)
same_but_ties(sr.query_batch(q, topk=5), fresh.query_batch(q, topk=5))
same_but_ties(sr.query_ivf_batch(q, topk=5, L=100),
              fresh.query_ivf_batch(q, topk=5, L=100))

# the distributed reconfigure, bit-identical to the single-device build
sr.reconfigure(nlist=128, iter=3)
e2 = Rii(pq)
e2.add_codes(e.codes, update_posting_lists=False)
e2.reconfigure(nlist=128, iter=3)
np.testing.assert_array_equal(e.coarse_centers, e2.coarse_centers)
assert e.posting_lists == e2.posting_lists, "not bit-identical"

# 2-D (hosts, chips): the host axis is the processes
mesh_hc = make_mesh_hc(n_chips=spp, device=device)
assert mesh_hc.shape == {"hosts": nproc, "chips": spp} and mesh_hc.world == nproc
sr2 = ShardedRii(e, mesh=mesh_hc)
ref2 = single(e, (nproc, spp), ("hosts", "chips"))
for kw in ({}, {"target_ids": tids}):
    same(sr2.query_batch(q, topk=5, **kw), ref2.query_batch(q, topk=5, **kw))
    same(sr2.query_ivf_batch(q, topk=5, L=100, **kw),
         ref2.query_ivf_batch(q, topk=5, L=100, **kw))
    np.testing.assert_allclose(sr2.query_batch(q, topk=5, **kw)[1],
                               sr.query_batch(q, topk=5, **kw)[1], rtol=1e-5)
X3 = (-4 - rng.random((128, 32))).astype(np.float32)
sr2.add(X3, update_posting_lists=True)
assert sr2._n_dev == n + 256 and sr2._engine_version == e._version
ids_n, _ = sr2.query_batch(X3[:4], topk=1)
assert (ids_n[:, 0] >= n + 128).all()
sr2.reconfigure(nlist=128, iter=3)
e3 = Rii(pq)
e3.add_codes(e.codes, update_posting_lists=False)
e3.reconfigure(nlist=128, iter=3)
assert e.posting_lists == e3.posting_lists, "2-D not bit-identical"
torch.distributed.destroy_process_group()
print(f"[p{pid}] MULTIPROCESS OK", flush=True)
'''


@pytest.mark.parametrize("nproc,spp", [(2, 4), (4, 1)])
def test_processes_distributed_engine(tmp_path, nproc, spp):
    _run_workers(tmp_path, nproc, spp, "cpu")


@pytest.mark.gpu
def test_nccl_processes_one_card_each(tmp_path):
    """One process a card (up to four), two shards each, over NCCL."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    _run_workers(tmp_path, min(4, torch.cuda.device_count()), 2, "cuda")


def _run_workers(tmp_path, nproc, spp, device):
    worker = tmp_path / "torch_mp_worker.py"
    worker.write_text(_WORKER)
    s = socket.socket()
    s.bind(("localhost", 0))
    port = str(s.getsockname()[1])
    s.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(nproc), port, repo, device,
         str(spp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=str(tmp_path)) for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:  # never leave a worker behind
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
        assert f"[p{i}] MULTIPROCESS OK" in out
