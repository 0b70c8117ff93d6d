"""Meshes of database shards and their placement (counterpart of
``rii_tpu.parallel.mesh``).

JAX's mesh is a grid of devices; torch has no virtual devices, so a
:class:`Mesh` here is an ordered list of shard placements, each a
``torch.device``. Several placements may name one device: that is how a CPU
process holds an eight-shard mesh, and how one card runs a four-shard mesh
(what four cards compute, on one). Across processes (``torch.distributed``,
see :func:`~rii_tpu_torch.parallel.init_distributed`) each rank holds only its
own shards, process-major: rank r holds shards ``[r * n_local, (r + 1) *
n_local)``, and ingestion transfers only those rows. The collectives are
``torch.distributed.all_gather`` over the mesh's process group (gloo for CPU
tensors, NCCL for CUDA tensors); within a process a gather is a
``torch.cat`` onto the merge device, the first local shard's device.
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from rii_tpu_torch._device import resolve_device

DATA_AXIS = "data"
HOST_AXIS = "hosts"
CHIP_AXIS = "chips"


class Mesh:
    """An ordered grid of database shards.

    Attributes:
        axis_names: ``("data",)``, or ``("hosts", "chips")`` (row-major: shard
            ``h * n_chips + c`` is chip c of host h).
        shape: {axis name: size}; ``size`` is the number of shards.
        devices: the ``torch.device`` of each shard this process holds, in
            shard order; ``local`` their global shard indexes.
        group: the ``torch.distributed`` process group the shards are spread
            over (None: one process holds them all); ``rank`` and ``world``
            within it.
    """

    def __init__(self, devices, axis_names, shape, group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = int(np.prod(list(self.shape.values())))
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        assert self.size % self.world == 0, (self.size, self.world)
        n_local = self.size // self.world
        self.devices = [torch.device(d) for d in devices]
        assert len(self.devices) == n_local, (len(self.devices), n_local)
        self.local = list(range(self.rank * n_local, (self.rank + 1) * n_local))
        self.merge_device = self.devices[0]

    def __repr__(self):
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices]}, "
                f"rank={self.rank}/{self.world})")


def _world_group():
    """The default process group when more than one process runs, else None."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def _local_devices(n_local, device, world):
    """Placements of this process's n_local shards. A bare ``"cuda"`` in a
    single process spreads them over the visible cards in contiguous
    blocks; a card named by index, or one process of several, puts them all
    on one card (the named or the current one)."""
    bare = torch.device(device)
    dev = resolve_device(device)
    if dev.type == "cuda" and bare.index is None and world == 1:
        ncards = torch.cuda.device_count()
        return [torch.device("cuda", i * ncards // n_local) for i in range(n_local)]
    return [dev] * n_local


def _default_local_count(device, world):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and world == 1:
        resolve_device(device)  # raises where no card is visible
        return torch.cuda.device_count()
    return 1


def make_mesh(n_shards=None, devices=None, device="cuda", axis_name=DATA_AXIS):
    """1-D mesh; axis = database shard.

    ``devices``: this process's shard placements, one per shard. Otherwise
    ``n_shards`` shards in all (over every process) on ``device``
    ("cuda" by default; raises where no card is visible); by default one
    shard per visible card (one per process across processes, one on the
    CPU)."""
    group = _world_group()
    world = 1 if group is None else dist.get_world_size(group)
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        n_local = len(devs)
        assert n_shards is None or n_shards == n_local * world, (n_shards, n_local)
    else:
        if n_shards is None:
            n_local = _default_local_count(device, world)
        else:
            assert n_shards % world == 0, (n_shards, world)
            n_local = n_shards // world
        devs = _local_devices(n_local, device, world)
    return Mesh(devs, (axis_name,), (n_local * world,), group=group)


def make_mesh_hc(n_hosts=None, n_chips=None, device="cuda"):
    """2-D ("hosts", "chips") mesh. :class:`~rii_tpu_torch.parallel.ShardedRii`
    shards rows over both axes and merges chips first, then hosts, so the
    cross-host hop carries n_hosts * topk rows a query instead of
    n_shards * topk. Across processes the host axis is the processes
    (n_hosts = world size, host h = rank h) and n_chips is each process's
    shard count; in one process both axes are placements of this process.
    Defaults: n_hosts = the world size, n_chips = the default shard count of
    :func:`make_mesh` (one per visible card; one on the CPU)."""
    group = _world_group()
    world = 1 if group is None else dist.get_world_size(group)
    if n_hosts is None:
        n_hosts = world
    if world > 1:
        assert n_hosts == world, \
            f"across processes the host axis is the processes: {n_hosts} != {world}"
    if n_chips is None:
        n_chips = _default_local_count(device, world)
    n_local = n_chips if world > 1 else n_hosts * n_chips
    devs = _local_devices(n_local, device, world)
    return Mesh(devs, (HOST_AXIS, CHIP_AXIS), (n_hosts, n_chips), group=group)


def put_sharded(mesh, arr, sharded=True):
    """Place a host array on the mesh: this process's shards only.

    ``sharded``: rows split in mesh order (``arr.shape[0]`` divisible by the
    shard count), a list of each local shard's rows on its device; else a
    list with one copy a local shard (shards on one device share it)."""
    arr = np.asarray(arr)
    if not sharded:
        copies = {}
        for dev in mesh.devices:
            if dev not in copies:
                copies[dev] = torch.tensor(arr, device=dev)
        return [copies[dev] for dev in mesh.devices]
    assert arr.shape[0] % mesh.size == 0, (arr.shape, mesh.size)
    rows = arr.shape[0] // mesh.size
    return [torch.tensor(arr[s * rows:(s + 1) * rows], device=dev)
            for s, dev in zip(mesh.local, mesh.devices)]


def shard_database(mesh, codes, norms):
    """Place (cap, M) codes and (cap,) norms row-sharded over the mesh.

    cap must be divisible by the mesh size (the caller pads capacity, so
    any mesh that divides it works). Returns two lists of this process's
    shards."""
    assert codes.shape[0] % mesh.size == 0, (codes.shape, mesh.size)
    return put_sharded(mesh, codes), put_sharded(mesh, norms)


def on_device(dev):
    """``dev`` as the calling thread's current card while its shard's work
    is launched; nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def gather(mesh, parts):
    """All shards' tensors in shard order, on the merge device.

    ``parts``: one tensor for each local shard, of one shape and dtype on
    every shard. Within a process this is a move onto the merge device;
    across processes an ``all_gather`` of the stacked local parts."""
    local = [p.to(mesh.merge_device) for p in parts]
    if mesh.group is None:
        return local
    stacked = torch.stack(local)
    out = [torch.empty_like(stacked) for _ in range(mesh.world)]
    dist.all_gather(out, stacked, group=mesh.group)
    return [t for blk in out for t in blk.unbind(0)]


def gather_processes(mesh, t):
    """One tensor a process, gathered in rank order (``[t]`` in one
    process). Every process passes one shape and dtype."""
    if mesh.group is None:
        return [t]
    out = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(out, t.contiguous(), group=mesh.group)
    return out
