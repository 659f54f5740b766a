"""The perf hillclimb: the port of ``repro/launch/hillclimb.py``.

For each selected (arch x shape) pair, re-traces the step
(``launch/dryrun.py``) under cumulative sets of the beyond-paper switches
(``sharding/opts.py``) and records the roofline terms per variant, so each
hypothesis -> change -> before/after cycle is one row.  The terms come from
the H100 constants of ``launch/mesh.py``; they are predictions from the
trace's counts, not measurements.  Usage (any host; no card):

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --pair gemma-2b:train_4k \\
      --variants baseline expand_kv expand_kv+chunked_ce \\
      --out EXPERIMENTS/hillclimb_torch
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.sharding import opts


def terms(rec):
    """A dry-run record's roofline terms, per device: ``compute_s`` (its
    FLOPs at the bf16 dense peak), ``memory_s`` (its unfused bytes at the
    HBM rate), ``collective_s`` (its collective bytes at one NVLink
    direction's rate; a lower bound where the model axis spans two nodes)
    and ``temp_gb`` (its peak temporaries)."""
    return {"compute_s": rec["flops"] / PEAK_FLOPS_BF16,
            "memory_s": rec["bytes_accessed"] / HBM_BW,
            "collective_s": sum(rec["collective_bytes"].values()) / NVLINK_BW,
            "temp_gb": rec.get("temp_size_in_bytes", 0) / 1e9}


def run_variant(arch, shape, variant: str, *, multi_pod=False, rank=64):
    opts.reset()
    names = [] if variant == "baseline" else variant.split("+")
    opts.set_opts(names)
    try:
        rec = dryrun.run_one(arch, shape, multi_pod=multi_pod, rank=rank,
                             verbose=False)
    finally:
        opts.reset()
    return {"arch": arch, "shape": shape, "variant": variant,
            **terms(rec), "raw": rec}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", action="append", required=True,
                    help="arch:shape (repeatable)")
    ap.add_argument("--variants", nargs="+", default=["baseline"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--out", default="EXPERIMENTS/hillclimb_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    print("arch,shape,variant,compute_s,memory_s,collective_s,temp_gb")
    for pair in args.pair:
        arch, shape = pair.split(":")
        for variant in args.variants:
            tag = f"{arch}__{shape}__{variant.replace('+', '_')}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                with open(path) as f:
                    r = json.load(f)
            else:
                try:
                    r = run_variant(arch, shape, variant,
                                    multi_pod=args.multi_pod, rank=args.rank)
                except Exception as e:
                    print(f"{arch},{shape},{variant},ERROR,{e}")
                    continue
                with open(path, "w") as f:
                    json.dump(r, f, indent=1)
            print(f"{arch},{shape},{variant},{r['compute_s']:.4f},"
                  f"{r['memory_s']:.4f},{r['collective_s']:.4f},"
                  f"{r['temp_gb']:.2f}")


if __name__ == "__main__":
    main()
