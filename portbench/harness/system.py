"""The system under test: the port's engine over the cell's data, each
set-up stage timed (host clock, each stage ended by a synchronise).

Only the port's public API is used: ``PQ`` and ``Rii``,
with the engine's stage statistics (``last_reconfigure_stats``,
``last_cache_build_stats``).
"""

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.harness.judge import train_rows
from portbench.reference.datagen import STREAMS, Mixture, host_rng, tags
from portbench.reference.exact import full_fp32
from rii_tpu_torch import PQ, Rii


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stages:
    """Seconds of each set-up stage, in order."""

    def __init__(self, device):
        self.device = device
        self.s = {}

    def run(self, name, fn):
        t = time.perf_counter()
        out = fn()
        sync(self.device)
        self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t
        return out


def build_engine(cfg, mix, device, stages, reset_peak):
    """Fit the codec, ingest the base chunk by chunk (drawn on the device,
    handed over as the numpy float32 that ``add`` takes), reconfigure.
    ``reset_peak()`` runs once the generator's training rows are on the
    host, just before the fit."""
    train = stages.run("data_s",
                       lambda: train_rows(cfg, mix).cpu().numpy())
    reset_peak()
    pq = stages.run("fit_s", lambda: PQ(M=cfg["M"], Ks=cfg["Ks"],
                                         device=device).fit(
        train, iter=cfg["pq_iter"]))
    del train
    engine = Rii(pq)
    for _, x in mix.chunks("base", cfg["N"]):
        rows = stages.run("data_s", lambda x=x: x.cpu().numpy())
        del x
        stages.run("ingest_s", lambda rows=rows: engine.add(
            rows, update_posting_lists=False))
    stages.run("reconfigure_s", lambda: engine.reconfigure(
        nlist=cfg["nlist"], iter=cfg["reconfigure_iter"]))
    return engine


def resolve_L(params, engine):
    """The cell's L: a number, or ``L_per_L0`` times the engine's L0."""
    if "L_per_L0" in params:
        return int(params["L_per_L0"]) * engine.L0
    return int(params["L"])


class SubsetTraffic:
    """Target sets of a subset mix: each item's tag, the sorted ids of every
    tag, and the tag each call asks for (uniform among the tags)."""

    def __init__(self, item_tags, ntags, rng, calls=1 << 20):
        self.item_tags = item_tags
        self.ids = [np.flatnonzero(item_tags == t).astype(np.int64)
                    for t in range(ntags)]
        self.order = rng.integers(0, ntags, size=calls)


def warm(engine, pool, params, L, subset=None):
    """Run every shape the cell's traffic will use once: the closed loop's
    batch (for a subset mix, once for every tag)."""
    kw = dict(topk=params["topk"], L=L, method=params["method"])
    qs = pool[:params["batch"]]
    if subset is None:
        for _ in range(3):
            engine.query_batch(qs, **kw)
        return
    for ids in subset.ids:
        engine.query_batch(qs, target_ids=ids, **kw)


def set_up(cell, seed, device):
    """Everything before the window: the data, the engine (its cache built
    by its first query) and the warm-up of the cell's shapes. The device's
    peak memory is reset just before the codec's fit. The data comes from
    the configuration's ``data.seed``; ``seed`` draws the subset traffic's
    tags."""
    cfg, p = cell.config, cell.params
    full_fp32()
    stages = Stages(device)
    # the dataset is the configuration's (one fixed draw, as SIFT1M is one
    # fixed set); the run's seed draws the traffic over it
    data_seed = cfg["data"]["seed"]
    mix = stages.run("data_s", lambda: Mixture(cfg["data"], data_seed,
                                               device))
    pool_t = stages.run("data_s", lambda: mix.take("query", cfg["queries"]))
    pool = pool_t.cpu().numpy()
    item_tags = subset = None
    if "subset" in p:
        sp = p["subset"]
        item_tags = stages.run("data_s", lambda: tags(
            cfg["N"], sp["tags"], sp["zipf"], data_seed, device))
        subset = SubsetTraffic(item_tags, sp["tags"],
                               host_rng(seed, STREAMS["traffic"], 1))

    def reset_peak():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

    engine = build_engine(cfg, mix, device, stages, reset_peak)
    L = resolve_L(p, engine)
    kw = dict(topk=p["topk"], L=L, method=p["method"])
    # the engine builds its device cache at its first query
    stages.run("cache_build_s", lambda: engine.query_batch(pool[:1], **kw))
    stages.run("warm_s", lambda: warm(engine, pool, p, L, subset))
    stats = {"reconfigure": dict(engine.last_reconfigure_stats),
             "cache_build": dict(engine.last_cache_build_stats)}
    return SimpleNamespace(engine=engine, pool=pool, pool_t=pool_t, mix=mix,
                           L=L, item_tags=item_tags, subset=subset,
                           stages=stages, stats=stats)
