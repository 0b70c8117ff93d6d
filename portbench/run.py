"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: builds the cell's system from the seed (set-up),
drives its traffic for ``--seconds`` (the window), then checks the answers
against the plain reference (``portbench/reference``) and prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number compared beside its limit. Set-up stages
and launch counts go to standard error on earlier lines; the checks are its
last lines.

``--control terms|rows`` puts the reference in the program's place for the
check, at the precision below the configuration's, in the program's form or
with every term from the rounded rows (the controls, which must come out not
correct); ``--control half`` puts it there at full precision over half of
the index (a planted fault, likewise). A run needs a CUDA card and fails
without one; it never falls back to the CPU.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FORBIDDEN = ("jax", "jaxlib", "flax", "rii_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``rii_tpu_torch`` is not ``rii_tpu``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(obj):
    print(json.dumps(obj), file=sys.stderr, flush=True)


def launch_counts():
    """The port's kernel wrappers' ``.launches`` counters."""
    from rii_tpu_torch.ops import hopper_i8, hopper_pq, hopper_scan
    out = {}
    for mod in (hopper_scan, hopper_pq, hopper_i8):
        for name, fn in vars(mod).items():
            if isinstance(getattr(fn, "launches", None), int):
                out[name] = fn.launches
    return out


class GcWatch:
    """Collections of the interpreter's garbage collector, by generation,
    and the seconds they took, while installed."""

    def __init__(self):
        self.collections = [0, 0, 0]
        self.seconds = 0.0
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.collections[info["generation"]] += 1
            self.seconds += time.perf_counter() - self._t


def power_limit():
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return res.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(bench, name, seed, seconds, trace, device, control=None,
             t0=None):
    """One run of cell ``name``; returns the result line's object."""
    import torch

    from portbench.harness import judge
    from portbench.harness.loops import Recorder, closed_loop
    from portbench.harness.system import set_up, sync
    from portbench.harness.trace import Slice, Trace, UnionSpy
    from portbench.reference.datagen import STREAMS, host_rng

    t0 = time.perf_counter() if t0 is None else t0
    cell = bench.cell(name)
    cfg, p = cell.config, cell.params
    cuda = device.type == "cuda"
    sut = set_up(cell, seed, device)
    engine, pool, pool_t, mix, L = sut.engine, sut.pool, sut.pool_t, sut.mix, sut.L
    item_tags, subset, stages, stats = sut.item_tags, sut.subset, sut.stages, sut.stats
    del sut  # the engine is freed before the reference runs
    rec = Recorder(engine)
    sl = spy = None
    if trace:
        sl = Slice(min(1.0, seconds / 4), min(2.0, seconds / 2), device)
        sl.prepare()
        spy = UnionSpy()
        spy.install()
        rec.traced = True
    launches0 = launch_counts()
    # set-up's objects (imports, data, the engine's host state) move out of
    # the collector's reach, so that a full collection in the window scans
    # only what the window made: otherwise one lands in some windows and
    # not others, a stall of tens of ms
    gc.collect()
    gc.freeze()
    gcw = GcWatch()
    gc.callbacks.append(gcw)
    setup_s = time.perf_counter() - t0
    log({"setup_s": setup_s, "stages": stages.s, **stats, "L": L,
         "N": engine.N, "nlist": engine.nlist})
    tick = None if sl is None else sl.tick
    ans, window = closed_loop(engine, pool, p, L, seconds,
                              host_rng(seed, STREAMS["traffic"]), subset, tick)
    sync(device)
    gc.callbacks.remove(gcw)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    launches = {k: v - launches0.get(k, 0) for k, v in launch_counts().items()
                if v != launches0.get(k, 0)}
    log({"window_s": window, "calls": len(rec.calls), "launches": launches,
         "gc_in_window": {"collections": gcw.collections,
                          "seconds": gcw.seconds}})

    metrics, dev_extra, breakdown = {}, {}, None
    if trace:
        spy.remove()
        tr = Trace(sl, rec.calls, spy.rows(), engine.N, cfg["D"], cfg["M"],
                   stats)
        for m in cell.per_layer:
            v = bench.reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev_extra = {"busy_s": tr.busy_us() * 1e-6,
                     "window_s": tr.window_us * 1e-6}
        breakdown = tr.breakdown()
        del tr, spy
    # the program's state the check follows (its codec and its codes), then
    # the program freed before the reference runs
    codes, codewords = engine.codes, engine.codewords
    del engine, rec, sl
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    answered = int(ans.ok.sum())
    e2e = {"qps": lambda: answered / window,
           "recall10": lambda: judge.recall10(cfg, mix, pool_t, ans,
                                              item_tags, device),
           "device_gib": lambda: peak / 2 ** 30,
           "setup_s": lambda: setup_s}
    # an end-to-end metric "<kind>.<qualifier>" (qps.pq) is <kind>, kept
    # apart so that its bound follows its own cells' spread
    values = {m["name"]: e2e[m["name"].split(".")[0]]()
              for m in cell.end_to_end}
    log({"end_to_end": values})
    if not trace:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    t_check = time.perf_counter()
    numbers = judge.checks(cfg, mix, pool_t, ans, codes, codewords,
                           item_tags, seed, device, control=control)
    log({"check_s": time.perf_counter() - t_check})
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]}
              for k in numbers}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power": power_limit() if cuda else None, **dev_extra}
    out = {"correct": judge.verdict(numbers, cell.limits),
           "attempted": int(ans.attempted), "failed": int((~ans.ok).sum()),
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv=None):
    from portbench.harness import judge
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=judge.CONTROLS, default=None)
    args = ap.parse_args(argv)

    from portbench.harness.spec import Bench
    bench = Bench()
    chips = bench.cell(args.workload).workload["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0),
                   control=args.control, t0=_T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
