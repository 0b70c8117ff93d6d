"""IVF batch latency of the two int8 bands of ``chip_smoke.py`` on one GPU:
the 10M band (int8 replica with pq code windows: its IVF batches run kernel
E) and the 4M band (bf16 replica with int8 windows: kernel G).

    python rii_tpu_torch/benchmarks/ivf_bands.py                  # this checkout
    python rii_tpu_torch/benchmarks/ivf_bands.py --root DIR       # another one

Each band is built as ``chip_smoke.py`` builds it (codewords
``RandomState(0).standard_normal``, codes ``RandomState(1)``, M=32, Ks=256,
D=128; 10M: N=10,000,000, nlist=3162, ``reserve(N + 100k)``, L = 2 L0; 4M:
N=4,000,000, nlist=2000, ``reserve(N + 50k)``, L = L0), with the package
imported from ``--root`` (default: the checkout that holds this file; a
checkout of an earlier commit, ``git archive <commit> | tar -x -C DIR``,
compares the two on one card, one process each). For Q=8 and 64 it times
``query_batch`` (method "auto", topk=10) on the host clock with a device
synchronize on each side: the median of ``reps`` batches after three warm
ones. Prints the card's name and power limit, then one JSON line per band
and Q.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BANDS = {"10M": dict(n=10_000_000, nlist=3162, n_add=100_000, L0s=2),
         "4M": dict(n=4_000_000, nlist=2000, n_add=50_000, L0s=1)}


def run(root, reps=9, m=32, ks=256, d=128):
    sys.path.insert(0, str(root))
    import torch
    from rii_tpu_torch import PQ, Rii
    dev = torch.device("cuda", 0)
    out = []
    for band, cfg in BANDS.items():
        rng = np.random.RandomState(0)
        cw = rng.standard_normal((m, ks, d // m)).astype(np.float32)
        codes = np.random.RandomState(1).randint(0, ks, (cfg["n"], m), dtype=np.uint8)
        qidx = rng.choice(cfg["n"], 64, replace=False)
        queries = (cw[np.arange(m)[None, :], codes[qidx].astype(np.int64)].reshape(64, d)
                   + rng.normal(0, 0.05, (64, d))).astype(np.float32)
        e = Rii(PQ.from_codewords(cw, device=dev))
        e.reserve(cfg["n"] + cfg["n_add"])
        for s0 in range(0, cfg["n"], 1 << 22):
            e.add_codes(codes[s0:s0 + (1 << 22)])
        e.reconfigure(nlist=cfg["nlist"])
        dc = e._ensure_cache()
        for qn in (8, 64):
            qs = queries[:qn]
            kw = dict(topk=10, method="auto", L=cfg["L0s"] * e.L0)
            for _ in range(3):
                e.query_batch(qs, **kw)
            walls = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                e.query_batch(qs, **kw)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            rec = {"band": band, "Q": qn, "tiers": [dc["mode"], dc["windows"]],
                   "wall_ms": float(np.median(walls)), "walls_ms": walls,
                   "root": str(root), "device": torch.cuda.get_device_name(dev)}
            out.append(rec)
            print(json.dumps(rec), flush=True)
        del e, dc
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose rii_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ivf_bands: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    run(Path(args.root).resolve(), reps=args.reps)


if __name__ == "__main__":
    main()
