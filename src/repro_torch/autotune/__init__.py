"""Autotuned Pallas variant generation (see docs/autotune.md).

Pipeline: each kernel package declares its tunable block/tile/unroll
axes in a ``space.py`` (:mod:`repro.autotune.space`); the tuner
enumerates valid configurations (:mod:`.generate`), measures or
analytically prices them per scenario bucket through the calibrate
machinery (:mod:`.measure`, resumable
:class:`~repro.calibrate.profile.HardwareProfile`), prunes
Pareto-dominated variants (:mod:`.prune`), and persists the winners in
a versioned :class:`~repro.autotune.catalog.VariantCatalog` whose
``install()`` registers them as first-class PBQP primitives via
``core.primitives.register_extension`` — rotating every serving
plan-cache key through the extension token.

CLI: ``python -m repro.launch.tune``.
"""
from .catalog import CATALOG_SCHEMA, EXTENSION_NAME, VariantCatalog, \
    base_registry_hash
from .generate import generate_variants, kernel_spaces, spaces
from .measure import analytic_measurer, kernel_variant_key, \
    plan_tune_sweep
from .prune import Candidate, candidates_from_costs, group_key, \
    prune_dominated
from .space import TunableSpace, params_tuple, variant_name, \
    variant_suffix
from .tuner import TuneResult, plan_only, tune

__all__ = [
    "CATALOG_SCHEMA", "EXTENSION_NAME", "VariantCatalog",
    "base_registry_hash", "generate_variants", "kernel_spaces", "spaces",
    "analytic_measurer", "kernel_variant_key", "plan_tune_sweep",
    "Candidate", "candidates_from_costs", "group_key", "prune_dominated",
    "TunableSpace", "params_tuple", "variant_name", "variant_suffix",
    "TuneResult", "plan_only", "tune",
]
