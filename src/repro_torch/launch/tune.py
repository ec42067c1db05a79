"""Autotuning CLI: sweep the CUDA kernels' launch spaces, prune, write a
catalog (port of the reference's ``launch/tune.py``, with the same flags
and output lines, plus ``--device``).

Enumerates every kernel package's tunable launch space (the tile and
cluster split count of the GEMM-based kernels, flash attention's query
tile and KV split, the layout transform's route), measures each valid
configuration per scenario bucket through the calibration machinery,
prunes Pareto-dominated variants, and writes the winners as a versioned
VariantCatalog JSON:

  PYTHONPATH=src python -m repro_torch.launch.tune --catalog variants.json
  PYTHONPATH=src python -m repro_torch.launch.tune --catalog variants.json \\
      --net alexnet --scale 1.0 --batches 1 8
  PYTHONPATH=src python -m repro_torch.launch.tune --catalog variants.json \\
      --device cpu --grid small --kernels matmul conv_im2col
  PYTHONPATH=src python -m repro_torch.launch.tune --catalog variants.json \\
      --device cpu --dry-run

``--device`` (default ``cuda``) is the port's device idiom: every entry
point of the port runs on the card unless told otherwise, and raises
without one.  Sweeps are resumable exactly like calibration: measurements
accumulate in a HardwareProfile (``--profile``, defaults next to the
catalog), covered keys are skipped on re-run, and ``--budget N`` caps how
many new measurements one invocation performs before writing a catalog
from whatever is covered so far.  ``--measure real`` times each
variant's pinned launch on the card (the default there);
``--measure analytic`` prices candidates with the card's fitted launch
models (the default off the card, where only the kernels' plain versions
run).  Install the result with ``VariantCatalog.load(path).install()``.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time


def _scenarios(args):
    from ..calibrate import scenario_grid, scenarios_from_net
    from ..serving import BucketPolicy

    policy = BucketPolicy()
    batches = tuple(args.batches)
    if args.net:
        from ..convnets import NETWORKS
        scns = []
        for name in args.net:
            scns.extend(scenarios_from_net(NETWORKS[name](args.scale),
                                           policy=policy, batches=batches))
    else:
        scns = scenario_grid(args.grid, policy=policy, batches=batches)
    return scns, policy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="autotune the CUDA kernels' launch spaces and write a "
                    "VariantCatalog of PBQP-registrable winners")
    ap.add_argument("--catalog", required=True,
                    help="VariantCatalog JSON to write")
    ap.add_argument("--profile", default=None,
                    help="HardwareProfile JSON holding the tuning "
                         "measurements (default: <catalog>.profile.json; "
                         "an existing one resumes the sweep)")
    ap.add_argument("--grid", default="small",
                    choices=("tiny", "small", "default"),
                    help="named scenario-bucket grid")
    ap.add_argument("--net", nargs="*", default=None,
                    help="tune exactly these networks' buckets "
                         "(alexnet, vgg-a..e, googlenet) instead of a grid")
    ap.add_argument("--scale", type=float, default=0.25,
                    help="network scale factor for --net")
    ap.add_argument("--batches", nargs="+", type=int, default=[1],
                    help="minibatch buckets to sweep")
    ap.add_argument("--kernels", nargs="*", default=None,
                    help="restrict to these kernel packages (matmul, "
                         "conv_direct, conv_im2col, winograd_gemm, "
                         "flash_attention, layout_transform)")
    ap.add_argument("--max-per-kernel", type=int, default=None,
                    help="cap the configurations tried per kernel "
                         "(first N of the enumeration; smoke tests)")
    ap.add_argument("--measure", default="auto",
                    choices=("auto", "real", "analytic"),
                    help="price candidates by timing their launches on "
                         "the card (real) or by the card's fitted launch "
                         "models (analytic); auto: real on a CUDA "
                         "device, analytic elsewhere")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--min-time", type=float, default=5e-3,
                    help="minimum timed seconds per repetition")
    ap.add_argument("--budget", type=int, default=None,
                    help="stop after N new measurements (resume later; "
                         "the catalog is still written from covered "
                         "entries)")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--fresh", action="store_true",
                    help="ignore an existing --profile")
    ap.add_argument("--device", default="cuda",
                    help="where to measure: cuda (default; raises "
                         "without a card) or cpu")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the variant pool and sweep plan; "
                         "measure nothing, write nothing")
    args = ap.parse_args(argv)

    import pathlib

    from ..autotune import plan_only, tune
    from ..calibrate import HardwareProfile, device_fingerprint
    from ..kernels.common import resolve_device

    device = resolve_device(args.device)
    fingerprint = device_fingerprint(device)
    scns, policy = _scenarios(args)
    variants, items, index = plan_only(
        scns, kernels=args.kernels, max_per_kernel=args.max_per_kernel,
        policy=policy, device=device)

    by_kind = collections.Counter(it.kind for it in items)
    print(f"tune plan: {len(variants)} candidate variants, "
          f"{len(items)} measurements ({dict(by_kind)})")
    if args.dry_run:
        by_kernel = collections.Counter(
            e[1].name.split("@")[0] if e[0] == "prim"
            else f"kernel:{e[1].kernel}" for e in index.values())
        for k, n in sorted(by_kernel.items()):
            print(f"  {k:<24} {n:4d} measurements")
        for it in items[:5]:
            print(f"  e.g. {it.label}")
        print("dry run: nothing measured, nothing written")
        return 0

    cat_path = pathlib.Path(args.catalog)
    prof_path = pathlib.Path(args.profile) if args.profile \
        else cat_path.with_suffix(".profile.json")
    profile = None
    if prof_path.exists() and not args.fresh:
        profile = HardwareProfile.load(prof_path)
        if profile.device != fingerprint:
            print(f"error: {prof_path} was measured on "
                  f"{profile.device!r}, this process is "
                  f"{fingerprint!r}; use --fresh or a "
                  f"different --profile", file=sys.stderr)
            return 2
        print(f"resuming from {prof_path} ({len(profile)} entries)")

    t0 = time.perf_counter()

    def progress(i, n, item, t):
        el = time.perf_counter() - t0
        eta = el / (i + 1) * (n - i - 1)
        print(f"[{i + 1}/{n}] {item.label}: {t * 1e3:.3f} ms "
              f"(elapsed {el:.0f}s, eta {eta:.0f}s)")

    res = tune(scns, kernels=args.kernels,
               max_per_kernel=args.max_per_kernel,
               measure_mode=args.measure, profile=profile,
               profile_path=prof_path, budget=args.budget,
               reps=args.reps, min_time=args.min_time,
               save_every=args.save_every, policy=policy,
               progress=progress, device=device)
    res.profile.save(prof_path)
    res.catalog.save(cat_path)
    print(f"measured {res.sweep['measured']}, skipped "
          f"{res.sweep['skipped']} covered, {res.sweep['remaining']} "
          f"remaining -> {prof_path}")
    print(f"catalog: {res.generated} generated, {res.surviving} "
          f"surviving, {res.pruned} pruned, "
          f"{len(res.catalog.kernels)} kernel-only winners -> "
          f"{cat_path} (content {res.catalog.content_hash()})")
    for name in res.catalog.survivors():
        print(f"  + {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
