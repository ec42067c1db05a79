"""The tuning pipeline: generate -> measure -> prune -> catalog (port of
the reference's ``autotune/tuner.py``).

One call, :func:`tune`, runs the whole loop the ``launch/tune.py`` CLI
and ``chip_smoke.py`` share.  Resumable like calibration: measurements
land in a :class:`HardwareProfile` keyed by the same ``prim::``/
``kernel::`` keys, covered keys are skipped, and a ``budget`` caps how
many *new* measurements one invocation performs.  It runs on the card
unless the caller passes ``device="cpu"``; with no GPU it raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..calibrate.profile import HardwareProfile, device_fingerprint
from ..calibrate.sweep import run_sweep
from ..core.costs import H100_SPEC, prim_cost_key
from ..core.primitives import Primitive
from ..core.scenario import Scenario
from ..kernels.common import resolve_device
from ..serving.bucketing import BucketPolicy, bucket_scenario
from .catalog import VariantCatalog
from .generate import kernel_spaces, spaces
from .measure import (
    analytic_measurer, default_measure_mode, kernel_variant_key,
    plan_tune_sweep,
)
from .prune import candidates_from_costs, prune_dominated

__all__ = ["TuneResult", "tune", "plan_only"]


@dataclass
class TuneResult:
    catalog: VariantCatalog
    profile: HardwareProfile
    #: run_sweep stats: measured / skipped / remaining
    sweep: Dict[str, int]
    #: generated / surviving / pruned counts
    generated: int = 0
    surviving: int = 0
    pruned: int = 0


def _candidate_pool(kernels: Optional[Sequence[str]],
                    max_per_kernel: Optional[int]
                    ) -> Tuple[List[Primitive], Dict[str, tuple]]:
    """Generated variants plus ``name -> (kernel, params)`` origins."""
    variants: List[Primitive] = []
    origin: Dict[str, tuple] = {}
    for kname, space in sorted(spaces().items()):
        if not space.registers:
            continue
        if kernels and kname not in kernels:
            continue
        cfgs = space.configs()
        if max_per_kernel is not None:
            cfgs = cfgs[:max_per_kernel]
        for cfg in cfgs:
            prim = space.make_primitive(cfg)
            variants.append(prim)
            origin[prim.name] = (kname, cfg)
    return variants, origin


def _buckets(scenarios: Sequence[Scenario],
             policy: BucketPolicy) -> List[Scenario]:
    out, seen = [], set()
    for raw in scenarios:
        scn = bucket_scenario(raw, policy)
        if scn.key() not in seen:
            seen.add(scn.key())
            out.append(scn)
    return out


def plan_only(scenarios: Sequence[Scenario], *,
              kernels: Optional[Sequence[str]] = None,
              max_per_kernel: Optional[int] = None,
              policy: Optional[BucketPolicy] = None, device=None):
    """What a tune run would measure (the CLI's ``--dry-run``); touches
    no device."""
    policy = policy or BucketPolicy()
    variants, origin = _candidate_pool(kernels, max_per_kernel)
    items, index = plan_tune_sweep(
        variants, scenarios, kernel_only=kernel_spaces(kernels),
        policy=policy, device=device)
    return variants, items, index


def tune(scenarios: Sequence[Scenario], *,
         kernels: Optional[Sequence[str]] = None,
         max_per_kernel: Optional[int] = None,
         measure_mode: str = "auto",
         profile: Optional[HardwareProfile] = None,
         profile_path=None,
         budget: Optional[int] = None,
         reps: int = 3, min_time: float = 5e-3,
         save_every: int = 20,
         policy: Optional[BucketPolicy] = None,
         progress: Optional[Callable] = None,
         device=None) -> TuneResult:
    """Run one (resumable) tuning pass and return the catalog.

    ``measure_mode``: ``"real"`` times the kernels' pinned launches on
    the card, ``"analytic"`` prices them with the card's fitted launch
    models (:func:`~.measure.analytic_measurer` under ``H100_SPEC``),
    ``"auto"`` picks real on a CUDA device and analytic elsewhere.
    ``device`` is the card unless told otherwise (raises without one);
    real measurement off the card raises, since only the kernels' plain
    versions run there.
    """
    policy = policy or BucketPolicy()
    dev = resolve_device(device)
    mode = default_measure_mode(dev) if measure_mode == "auto" \
        else measure_mode
    if mode not in ("real", "analytic"):
        raise ValueError(f"measure_mode {mode!r}")
    if mode == "real" and dev.type != "cuda":
        raise ValueError(f"real measurement times the CUDA kernels; on "
                         f"{dev} only their plain versions run (use "
                         f"measure_mode='analytic')")

    variants, origin = _candidate_pool(kernels, max_per_kernel)
    konly = kernel_spaces(kernels)
    items, index = plan_tune_sweep(variants, scenarios,
                                   kernel_only=konly, policy=policy,
                                   device=dev)
    buckets = _buckets(scenarios, policy)

    if profile is None:
        profile = HardwareProfile.new(reps=reps, min_time=min_time,
                                      device=device_fingerprint(dev))
    measure = analytic_measurer(index, H100_SPEC) \
        if mode == "analytic" else None
    sweep = run_sweep(profile, items, reps=reps, min_time=min_time,
                      save_path=profile_path, save_every=save_every,
                      max_entries=budget, progress=progress,
                      measure=measure)

    # ---- dominance pruning over everything the profile now covers ----
    pool = list(variants)
    vnames = set(origin)
    from ..core.primitives import registry
    pool += [p for p in registry()
             if p.family == "pallas" and not p.params
             and p.name not in vnames]
    cands = candidates_from_costs(
        pool, buckets,
        lambda p, s: profile.get(prim_cost_key(p.name, s)))
    survivors, pruned = prune_dominated(cands)
    surviving = set(survivors)

    catalog = VariantCatalog.new(device=profile.device, measure=mode)
    by_name = {c.name: c for c in cands}
    for name, (kname, cfg) in sorted(origin.items()):
        c = by_name[name]
        costs = dict(c.costs)
        catalog.variants[name] = {
            "kernel": kname,
            "params": {k: int(v) for k, v in cfg.items()},
            "pruned": name not in surviving,
            **({"pruned_by": pruned[name]} if name in pruned else {}),
            "costs": costs,
        }

    # ---- kernel-only winners: best config per bucket ----
    for space, cfgs in konly:
        for scn in buckets:
            best = None
            for params in cfgs:
                sec = profile.get(kernel_variant_key(space, params, scn))
                if sec is None:
                    continue
                if best is None or sec < best[1]:
                    best = (params, sec)
            if best is not None:
                catalog.kernels[f"{space.kernel}::{scn.key()}"] = {
                    "params": {k: int(v) for k, v in best[0].items()},
                    "seconds": best[1],
                }

    n_surv = len(catalog.survivors())
    return TuneResult(catalog=catalog, profile=profile, sweep=sweep,
                      generated=len(variants), surviving=n_surv,
                      pruned=len(origin) - n_surv)
