"""On-device cost-table calibration CLI (port of the reference's
``launch/calibrate.py``, with the same flags and output lines).

Sweeps the primitive library (and optionally the standalone kernels)
across a grid of scenario buckets, timing each on the device, and
writes/extends a versioned HardwareProfile JSON:

  PYTHONPATH=src python -m repro_torch.launch.calibrate --out hw.json
  PYTHONPATH=src python -m repro_torch.launch.calibrate --out hw.json \\
      --net alexnet --scale 1.0 --batches 1 8 --kernels on
  PYTHONPATH=src python -m repro_torch.launch.calibrate --out hw.json \\
      --device cpu --grid tiny --dry-run

``--device`` (default ``cuda``) is the port's device idiom, not a new
feature: every entry point of the port runs on the card unless told
otherwise, and raises without one.  On an sm_90 card ``--kernels auto``
means on and the ``kernel`` primitives are swept; elsewhere ``auto``
means off and the ``kernel`` primitives are excluded, since off the
card only their plain versions would run.

Sweeps are resumable: an existing ``--out`` profile is extended (covered
keys are skipped, progress is saved every ``--save-every`` entries), so
interrupting and re-running continues where it stopped.  ``--dry-run``
prints the sweep plan and coverage without timing anything.  Select
with the result through ``repro_torch.calibrate.CalibratedCostModel``.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time


def _plan(args, device, fingerprint):
    from ..calibrate import plan_sweep, scenario_grid, scenarios_from_net
    from ..calibrate.model import measured_on_sm90
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

    on_card = measured_on_sm90(fingerprint)  # where the kernels run
    kernels = on_card if args.kernels == "auto" else args.kernels == "on"
    # kernel *primitives* follow the device, never the --kernels flag: a
    # CPU sweep of them would store plain-version timings that
    # CalibratedCostModel could then serve as kernel costs.
    exclude = () if on_card else ("kernel",)
    items = plan_sweep(scns, families=args.families or None,
                       exclude_tags=exclude, dt=not args.no_dt,
                       kernels=kernels, fused=not args.no_fused,
                       policy=policy, device=device)
    return scns, items


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="calibrate on-device cost tables for PBQP selection")
    ap.add_argument("--out", required=True,
                    help="HardwareProfile JSON to create or extend")
    ap.add_argument("--grid", default="small",
                    choices=("tiny", "small", "default"),
                    help="named scenario-bucket grid")
    ap.add_argument("--net", nargs="*", default=None,
                    help="calibrate exactly these networks' buckets "
                         "(alexnet, vgg-a..e, googlenet) instead of a grid")
    ap.add_argument("--scale", type=float, default=0.25,
                    help="network scale factor for --net")
    ap.add_argument("--batches", nargs="+", type=int, default=[1],
                    help="minibatch buckets to sweep (e.g. 1 4 16); "
                         "batched entries time the whole batched "
                         "invocation, pricing the batched serving path")
    ap.add_argument("--families", nargs="*", default=None,
                    help="restrict to these primitive families")
    ap.add_argument("--kernels", default="auto",
                    choices=("auto", "on", "off"),
                    help="standalone kernel microbenchmarks "
                         "(auto: only on an sm_90 card)")
    ap.add_argument("--no-dt", action="store_true",
                    help="skip layout-transform measurements")
    ap.add_argument("--no-fused", action="store_true",
                    help="skip fused (primitive, layout) pair "
                         "measurements — fused-edge pricing then falls "
                         "back to the analytic discount")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--min-time", type=float, default=5e-3,
                    help="minimum timed seconds per repetition")
    ap.add_argument("--max-entries", type=int, default=None,
                    help="stop after N new measurements (resume later)")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--fresh", action="store_true",
                    help="ignore an existing --out profile")
    ap.add_argument("--device", default="cuda",
                    help="where to measure: cuda (default; raises "
                         "without a card) or cpu")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the sweep plan and coverage; measure "
                         "nothing, write nothing")
    args = ap.parse_args(argv)

    import pathlib

    from ..calibrate import HardwareProfile, device_fingerprint, registry_hash
    from ..kernels.common import resolve_device

    device = resolve_device(args.device)
    fingerprint = device_fingerprint(device)
    scns, items = _plan(args, device, fingerprint)

    out = pathlib.Path(args.out)
    profile = None
    if out.exists() and not args.fresh:
        profile = HardwareProfile.load(out)
        if profile.device != fingerprint:
            print(f"error: {out} was measured on {profile.device!r}, this "
                  f"process is {fingerprint!r}; use --fresh or a "
                  f"different --out", file=sys.stderr)
            return 2
        if profile.registry != registry_hash():
            print(f"note: primitive registry changed since {out} was "
                  f"created; uncovered additions will be measured",
                  file=sys.stderr)
        if (profile.reps, profile.min_time) != (args.reps, args.min_time):
            print(f"note: measurement discipline changes from "
                  f"reps={profile.reps} min_time={profile.min_time} to "
                  f"reps={args.reps} min_time={args.min_time}; the "
                  f"profile records the latest sweep's discipline",
                  file=sys.stderr)
            if not args.dry_run:
                profile.reps, profile.min_time = args.reps, args.min_time
    if profile is None:
        profile = HardwareProfile.new(reps=args.reps,
                                      min_time=args.min_time,
                                      device=fingerprint)

    by_kind = collections.Counter(it.kind for it in items)
    covered = profile.covered(it.key for it in items)
    print(f"sweep plan: {len(scns)} scenario buckets, {len(items)} "
          f"measurements ({dict(by_kind)}), {covered} already covered, "
          f"{len(items) - covered} to go")
    print(f"device {fingerprint} | registry {registry_hash()} "
          f"| reps={args.reps} min_time={args.min_time}")

    if args.dry_run:
        fam = collections.Counter(it.label.split(":")[0] for it in items
                                  if it.kind == "prim")
        for f, n in sorted(fam.items()):
            print(f"  prim family {f:<10} {n:4d} measurements")
        for it in items[:5]:
            print(f"  e.g. {it.label}")
        print("dry run: nothing measured, nothing written")
        return 0

    t0 = time.perf_counter()

    def progress(i, n, item, t):
        el = time.perf_counter() - t0
        eta = el / (i + 1) * (n - i - 1)
        print(f"[{i + 1}/{n}] {item.label}: {t * 1e3:.3f} ms "
              f"(elapsed {el:.0f}s, eta {eta:.0f}s)")

    from ..calibrate import run_sweep
    report = run_sweep(profile, items, reps=args.reps,
                       min_time=args.min_time, save_path=out,
                       save_every=args.save_every,
                       max_entries=args.max_entries, progress=progress)
    print(f"measured {report['measured']}, skipped {report['skipped']} "
          f"covered, {report['remaining']} remaining -> {out} "
          f"({len(profile)} entries, content {profile.content_hash()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
