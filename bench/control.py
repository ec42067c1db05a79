"""Readings that set a cell's limits: the program's and the control's.

    python bench/control.py --workload <cell> --seeds 1 2 3 ... --seconds 3

Runs the cell once per seed in one process, each with a short window at
the cell's own load, and prints one JSON line per seed: the program's
compared number and the control's (the reference in TF32 put in the
program's place, on the same images and weights).  The lower reading of
a limit is the largest of the program's, the upper one the smallest of
the control's.  The benchmark's own runs never run the control.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "bench"))
    import cell
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = cell.run(args.workload, seed, args.seconds, False,
                       t_start=time.perf_counter(), control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": out["correct"],
            "compared_images": out["compared_images"],
            "program": out["checks"]["logit_rel_err"]["value"],
            "control": out["control_logit_rel_err"],
            "failed": out["failed"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
