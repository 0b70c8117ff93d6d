"""Readings of the numbers that decide ``correct``, for setting their limits.

    python3 portbench/readings.py --workload <cell> --seeds 11,12,13 \
        --seconds 2 --controls terms,rows,half --control-seeds 3 \
        --faults w1,fit0

Builds the cell's system once (its data is the configuration's, whatever
the seed), then for each seed drives the cell's closed loop for
``--seconds`` and prints one JSON line with the check's numbers on the
program's answers, as ``run.py`` computes them. On the first
``--control-seeds`` seeds it also reads each control of ``--controls``
(``judge.CONTROLS``) and each planted fault of ``--faults``: ``w1``, the
program at L = L0 where the cell asks for a multiple of L0 (a probe width
of one); ``fit0``, the codec fitted with no k-means iteration (its starting
rows as codewords), read by ``fit_excess``. The readings and the limits set
from them are in PERF.md. Needs a CUDA card.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    import argparse

    import torch

    from portbench.harness import judge
    from portbench.harness.loops import closed_loop
    from portbench.harness.spec import Bench
    from portbench.harness.system import SubsetTraffic, set_up
    from portbench.reference.datagen import STREAMS, host_rng
    from rii_tpu_torch import PQ

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", default="")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = Bench().cell(args.workload)
    cfg, p = cell.config, cell.params
    seeds = [int(s) for s in args.seeds.split(",")]
    t = time.perf_counter()
    sut = set_up(cell, seeds[0], dev)
    ref_cw = judge.reference_codebook(cfg, sut.mix)
    print(json.dumps({"setup_s": time.perf_counter() - t}), flush=True)
    engine = sut.engine

    def answers(seed, L):
        subset = None
        if sut.subset is not None:
            subset = SubsetTraffic(sut.item_tags, p["subset"]["tags"],
                                   host_rng(seed, STREAMS["traffic"], 1))
        ans, _ = closed_loop(engine, sut.pool, p, L, args.seconds,
                             host_rng(seed, STREAMS["traffic"]), subset)
        return ans

    def emit(seed, kind, numbers, seconds=None):
        print(json.dumps({"seed": seed, "kind": kind, "numbers": numbers,
                          "correct": judge.verdict(numbers, cell.limits),
                          "check_s": seconds}), flush=True)

    def check(ans, seed, control=None):
        t = time.perf_counter()
        out = judge.checks(cfg, sut.mix, sut.pool_t, ans, engine.codes,
                           engine.codewords, sut.item_tags, seed, dev,
                           control=control, ref_cw=ref_cw)
        return out, time.perf_counter() - t

    controls = [c for c in args.controls.split(",") if c]
    faults = [f for f in args.faults.split(",") if f]
    for i, seed in enumerate(seeds):
        ans = answers(seed, sut.L)
        emit(seed, "program", *check(ans, seed))
        if i >= args.control_seeds:
            continue
        for c in controls:
            emit(seed, c, *check(ans, seed, c))
        if "w1" in faults and "L_per_L0" in p:
            emit(seed, "w1", *check(answers(seed, engine.L0), seed))
        if "fit0" in faults:
            train = judge.train_rows(cfg, sut.mix).cpu().numpy()
            cw0 = PQ(M=cfg["M"], Ks=cfg["Ks"], device=dev).fit(
                train, iter=0).codewords
            _, x = judge.sample_rows(sut.mix, cfg["N"],
                                     host_rng(seed, STREAMS["sample"]))
            emit(seed, "fit0", {"fit_excess": judge.fit_excess(
                x, torch.as_tensor(cw0, device=dev), ref_cw)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
