"""Measured-cost calibration, on PyTorch (port of ``repro.calibrate``).

The paper's selections are only optimal with respect to *measured*
per-primitive and per-transform costs, so this package sweeps every
registered primitive and kernel across a grid of scenario buckets, times
them on the device, and persists the results as versioned per-device
cost tables that drive selection.

* :mod:`.profile` — :class:`HardwareProfile`: the on-disk table, keyed
  by device fingerprint + primitive-registry hash;
* :mod:`.sweep`   — resumable plan/run split over (primitive, bucket)
  pairs, layout transforms and standalone kernel microbenchmarks;
* :mod:`.model`   — :class:`CalibratedCostModel`: serves measured
  costs with analytic fallback for uncovered buckets, and folds the
  profile's content hash into ``CostModel.version()``.

Entry point: ``python -m repro_torch.launch.calibrate`` (build a
profile; on the card by default, ``--device cpu`` for the CPU).
"""
from .model import CalibratedCostModel
from .profile import (
    PROFILE_SCHEMA, HardwareProfile, device_fingerprint, registry_hash,
)
from .sweep import (
    GRIDS, SweepItem, plan_sweep, run_sweep, scenario_grid,
    scenarios_from_net,
)

__all__ = [
    "CalibratedCostModel",
    "PROFILE_SCHEMA", "HardwareProfile", "device_fingerprint",
    "registry_hash",
    "GRIDS", "SweepItem", "plan_sweep", "run_sweep", "scenario_grid",
    "scenarios_from_net",
]
