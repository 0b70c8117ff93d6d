"""A tiny copy of the benchmark for the CPU tests: the real mixes and
metric readers over a configuration cut to a few thousand rows, with limits
of its own."""

import json
import shutil
from pathlib import Path

from portbench.harness.spec import HOME, ROOT, Bench

TINY = {"N": 4096, "D": 16, "queries": 256, "M": 4, "Ks": 16,
        "train_rows": 1024, "nlist": 16,
        "data": {"dim": 16, "modes": 64, "sigma": 0.05, "zipf": 1.0,
                 "chunk_rows": 1024, "seed": 99}}
# the real cell each tiny cell takes its metrics from, with its traffic cut
# to the tiny index
CELLS = {
    "tiny.bulk": ("sift1m_m64.bulk", "bulk", {"batch": 64, "L": 1024}),
    "tiny.subset": ("sift1m_m64.subset", "subset", {
        "L": 1024, "subset": {"tags": 4, "zipf": 1.0}}),
}
# The tiny cells' limits, from their own readings on the CPU, where every
# route is float32. Sound runs read fit_excess 0.037, code_excess 0,
# dist_gap 2.3e-7, dist_mean 6e-8, sel_miss 0. The fp8 control reads
# dist_gap 0.036 (terms) and 0.009-0.018 (rows), dist_mean 0.009 and 0.0013,
# code_excess 1.0; half the rows scanned, sel_miss 0.07-0.18; the fit with
# no iteration fit_excess 1.0, the wrong sub-space split 1.4.
LIMITS = {"missing": 0, "bad": 0, "fit_excess": 0.3, "code_excess": 1e-3,
          "dist_gap": 1e-4, "dist_mean": 1e-5, "sel_miss": 0.02}


def make_tiny(tmp):
    """A benchmark root under ``tmp`` with the tiny cells."""
    tmp = Path(tmp)
    home = tmp / "bench"
    (home / "configs").mkdir(parents=True)
    (home / "cells").mkdir()
    for d in ("mixes", "metrics"):
        shutil.copytree(HOME / d, home / d)
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / real["configs"][0]["file"]).read_text())
    cfg.update(TINY, name="tiny")
    (home / "configs" / "tiny.json").write_text(json.dumps(cfg))
    spec = dict(real)
    spec["configs"] = [{"name": "tiny", "source": "tests",
                        "file": "bench/configs/tiny.json", "reduced": [],
                        "why": "tests"}]
    spec["workloads"] = []
    for name, (src, traffic, params) in CELLS.items():
        spec["workloads"].append({"name": name, "config": "tiny",
                                  "traffic": traffic, "chips": 1,
                                  "why": "tests"})
        (home / "cells" / f"{name}.json").write_text(json.dumps(
            {"traffic": params, "limits": LIMITS}))

    def rename(names):
        return [name for name, (src, _, _) in CELLS.items() if src in names]

    spec["end_to_end"] = [dict(m, workloads=rename(m["workloads"]))
                          if "workloads" in m else m
                          for m in real["end_to_end"]]
    spec["per_layer"] = [dict(m, workloads=rename(m["workloads"]))
                         if "workloads" in m else m
                         for m in real["per_layer"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(root=tmp, home=home)
