"""Batch ablation harness on the PyTorch port: run the pipeline demo across
module combinations.

The port's counterpart of scripts/batch_evaluate.py (itself the reference's
GSLAM-DIYSLAM/scripts/batch_evaluat.py): the same arguments, the same
axes mapped the same way, and the same files. Each combination runs
`examples/torch_pipeline_demo.py`'s `run_demo` in a subprocess of its own
on `--device` (default cuda; it raises without one) and writes
OUT_ROOT/<combination>/stdout.log (the run's standard error) and
metrics.json (run_demo's metrics, plus `launches`:
each port kernel's launch count over the run, counted from 0); then
OUT_ROOT/summary.json (every combination's metrics) and aggregate.json
(mean and standard deviation over the seeds of each group of runs that
differ only in `seed`). A combination whose run fails prints FAILED, and
the harness then exits 1.

Usage:
    python scripts/torch_batch_evaluate.py OUT_ROOT [--device cuda|cpu] \
        "fixture=flat,real" "gps=0.5" "refresh=1,0" "seed=0,1"

Each `key=v1,v2` argument enumerates values; the cartesian product runs.
Axes: SLAM.LoopClose, SLAM.nFeature, fixture (flat, parallax, real), seed,
gps (the GPS noise sigma in meters; 0 or off for none), refresh (0 or off
turns the mosaic's pose refresh off); any other key is a Svar key that
passes through to the demo's config (Tracker, Matcher, ...).
"""
import argparse
import itertools
import json
import math
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNNER = r"""
import json, sys
sys.path[:0] = [{repo!r}, {repo!r} + "/examples"]
from pislamfusion_tpu_torch._build import kernel_wrappers
from torch_pipeline_demo import run_demo
wrappers = kernel_wrappers()
for w in wrappers.values():
    w.launches = 0
m = run_demo({out!r}, verbose=False, device={device!r},
             **json.loads(sys.argv[2]))
m["launches"] = {{k: w.launches for k, w in wrappers.items()}}
print("METRICS " + json.dumps(m))
"""


def parse_axes(specs):
    """["key=v1,v2", ...] -> the cartesian product of (key, value) pairs."""
    axes = []
    for spec in specs:
        key, _, vals = spec.partition("=")
        axes.append([(key, v) for v in vals.split(",")])
    return list(itertools.product(*axes)) if axes else [()]


def combo_name(combo):
    """The run's directory name, as scripts/batch_evaluate.py names it."""
    return "_".join(f"{k.split('.')[-1]}-{v}" for k, v in combo) \
        or "default"


def combo_kwargs(combo):
    """run_demo's keyword arguments for one combination
    (scripts/batch_evaluate.py's mapping)."""
    kwargs = {"overrides": {}}
    for k, v in combo:
        if k == "SLAM.LoopClose":
            kwargs["loop_close"] = v not in ("0", "false")
        elif k == "SLAM.nFeature":
            kwargs["n_feats"] = int(v)
        elif k == "fixture":     # scene family
            kwargs["fixture"] = v
        elif k == "seed":        # texture/world RNG seed
            kwargs["seed"] = int(v)
        elif k == "gps":         # per-frame GPS noise sigma in meters
            kwargs["gps_sigma"] = (float(v)
                                   if v not in ("0", "off") else None)
        elif k == "refresh":     # mosaic pose-refresh machinery on/off
            if v in ("0", "off"):
                kwargs["overrides"]["Fusion.RefreshCacheMB"] = "0"
                kwargs["overrides"]["Fusion.FinalRefresh"] = "0"
        else:   # any other Svar key (Tracker, Matcher, ...) passes through
            kwargs["overrides"][k] = v
    return kwargs


def run_combo(combo, out_dir, device):
    """One combination in a subprocess: its metrics, or None if it
    failed."""
    code = RUNNER.format(repo=REPO, out=out_dir, device=device)
    with open(os.path.join(out_dir, "stdout.log"), "w") as log:
        r = subprocess.run(
            [sys.executable, "-c", code, json.dumps(dict(combo)),
             json.dumps(combo_kwargs(combo))],
            stdout=subprocess.PIPE, stderr=log, text=True)
    metrics = None
    for line in r.stdout.splitlines():
        if line.startswith("METRICS "):
            metrics = json.loads(line[8:])
    return metrics if r.returncode == 0 else None


def aggregate_over_seeds(results):
    """{group: {"n_runs", metric: {"mean", "std"}}} over the runs that
    differ only in `seed` (scripts/batch_evaluate.py's
    _aggregate_over_seeds)."""
    groups = {}
    for name, m in results.items():
        if m is None:
            continue
        base = re.sub(r"_?seed-\d+", "", name) or "default"
        groups.setdefault(base, []).append(m)
    agg = {}
    for base, ms in groups.items():
        row = {"n_runs": len(ms)}
        for key in ("tracked_ratio", "ate_pct", "psnr", "points",
                    "keyframes"):
            vals = [m[key] for m in ms if key in m]
            mean = sum(vals) / len(vals)
            std = math.sqrt(sum((v - mean) ** 2 for v in vals)
                            / max(len(vals) - 1, 1))
            row[key] = {"mean": round(mean, 4), "std": round(std, 4)}
        agg[base] = row
    return agg


def write_aggregate(out_root, results):
    """Write aggregate.json and print a line a group."""
    agg = aggregate_over_seeds(results)
    with open(os.path.join(out_root, "aggregate.json"), "w") as f:
        f.write(json.dumps(agg, indent=1))
    for base in sorted(agg):
        r = agg[base]
        print(f"{base}: ATE {r['ate_pct']['mean']:.2f}+-"
              f"{r['ate_pct']['std']:.2f}% "
              f"PSNR {r['psnr']['mean']:.1f}+-{r['psnr']['std']:.1f} dB "
              f"tracked {100 * r['tracked_ratio']['mean']:.0f}% "
              f"(n={r['n_runs']})", flush=True)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_root")
    ap.add_argument("axes", nargs="*", metavar="key=v1,v2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_intermixed_args(argv)
    results = {}
    for combo in parse_axes(args.axes):
        name = combo_name(combo)
        out_dir = os.path.join(args.out_root, name)
        os.makedirs(out_dir, exist_ok=True)
        print(f"== {name} ==", flush=True)
        metrics = run_combo(combo, out_dir, args.device)
        results[name] = metrics
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            f.write(json.dumps(metrics, indent=1))
        if metrics:
            print(f"   tracked {100 * metrics['tracked_ratio']:.0f}% "
                  f"ATE {metrics['ate_pct']:.2f}% "
                  f"PSNR {metrics['psnr']:.1f} dB "
                  f"({metrics['wall_s']:.0f}s, "
                  f"{1e3 * metrics['wall_s'] / metrics['frames']:.1f} ms "
                  "a frame)", flush=True)
        else:
            print("   FAILED (see stdout.log)", flush=True)
    with open(os.path.join(args.out_root, "summary.json"), "w") as f:
        f.write(json.dumps(results, indent=1))
    write_aggregate(args.out_root, results)
    return 1 if any(m is None for m in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
