"""CalibratedCostModel: serve measured costs, fall back analytically.

Port of the reference's ``calibrate/model.py``.  Lookups, fallbacks and
the hit accounting are the reference's, so that on the same profile the
two packages price every (primitive, scenario), transform and fused edge
alike.  The port's differences: the device check fingerprints the
device the caller names (the card by default), and the kernel
primitives carry the tag ``kernel`` where the reference's carry
``tpu-only``.

The paper's headline result depends on *measured* per-primitive and
per-transform costs; the analytic roofline is only the "simple
heuristic" it is compared against.  This model closes that gap for the
serving path: costs come from a :class:`~repro_torch.calibrate.profile.
HardwareProfile` measured offline on the target device, and any
(primitive, scenario) or transform the sweep did not cover falls back to
a configurable analytic model — selection never fails just because
coverage is partial.

Scenario lookup goes through :func:`repro_torch.serving.bucketing.
bucket_scenario`: per-layer scenarios are canonicalized onto the same
finite bucket grid the sweep measured, so one sweep prices every request
shape the serving tier can produce (the sweep and the model must agree
on the :class:`~repro_torch.serving.bucketing.BucketPolicy`).

``version()`` folds in the profile's content hash, the bucket policy and
the fallback's own version: *any* recalibration — a new device, a new
measurement, an edited table — changes the version string, and the
serving plan cache (keyed on it) re-solves instead of serving plans that
were optimal only for the old numbers.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..core.costs import (
    AnalyticCostModel, CostModel, collective_cost_key, fused_cost_key,
    prim_cost_key, transform_cost_key,
)
from ..core.layouts import transform_feasible
from ..core.primitives import Primitive
from ..core.scenario import Scenario
from ..serving.bucketing import BucketPolicy, bucket_scenario, bucket_shape
from .profile import HardwareProfile, device_fingerprint

__all__ = ["CalibratedCostModel", "measured_on_sm90"]


def measured_on_sm90(fingerprint: str) -> bool:
    """Whether a profile's device fingerprint names an sm_90 card, the
    one the port's CUDA kernels are built for."""
    parts = fingerprint.split(":")
    return parts[0] == "cuda" and len(parts) == 4 and parts[2] == "sm90"


class CalibratedCostModel(CostModel):
    """Measured cost tables with analytic fallback for uncovered buckets.

    Parameters
    ----------
    profile:
        The measured table (``HardwareProfile.load(path)``).
    fallback:
        Prices anything the profile does not cover; defaults to
        :class:`~repro_torch.core.costs.AnalyticCostModel` (the CPU
        spec, as in the reference; on the card pass
        ``AnalyticCostModel(H100_SPEC)``).
    policy:
        Bucket policy mapping scenarios onto the profile's grid; must
        match the policy the sweep was planned with.
    check_device:
        When True (default), a profile measured on a different device
        class than ``device`` raises ``ValueError`` — measured numbers
        are only transferable when you say so (``check_device=False``,
        the PolyDL-style cross-device transfer case).
    exclude_tags:
        Primitives carrying any of these tags are priced infinite, table
        entry or not.  Defaults to ``("kernel",)`` unless the profile was
        measured on an sm_90 card — a CPU profile must never legitimize
        a CUDA kernel (any CPU timing of one times its plain version).
    device:
        The device the costs are for (the card unless told otherwise;
        raises without one), checked against the profile's fingerprint.
    """

    def __init__(self, profile: HardwareProfile, *,
                 fallback: Optional[CostModel] = None,
                 policy: Optional[BucketPolicy] = None,
                 check_device: bool = True,
                 exclude_tags: Optional[Tuple[str, ...]] = None,
                 device=None) -> None:
        if check_device and profile.device != device_fingerprint(device):
            raise ValueError(
                f"profile measured on {profile.device!r} but this process "
                f"runs on {device_fingerprint(device)!r}; pass "
                f"check_device=False to transfer it anyway")
        self.profile = profile
        self.fallback = fallback or AnalyticCostModel()
        self.policy = policy or BucketPolicy()
        if exclude_tags is None:
            exclude_tags = () if measured_on_sm90(profile.device) \
                else ("kernel",)
        self.exclude_tags = tuple(exclude_tags)
        #: lookup accounting: how often the table actually served
        self.table_hits = 0
        self.fallback_hits = 0

    # -----------------------------------------------------------------
    def _version_fields(self) -> str:
        return (f"profile={self.profile.content_hash()}"
                f"|policy={self.policy!r}"
                f"|excl={sorted(self.exclude_tags)}"
                f"|fallback={self.fallback.version()}")

    # -----------------------------------------------------------------
    def primitive_cost(self, prim: Primitive, scn: Scenario) -> float:
        if any(t in prim.tags for t in self.exclude_tags):
            return float("inf")
        b = bucket_scenario(scn, self.policy)
        v = self.profile.get(prim_cost_key(prim.name, b))
        if v is not None:
            self.table_hits += 1
            return v
        self.fallback_hits += 1
        return self.fallback.primitive_cost(prim, scn)

    def transform_cost(self, src: str, dst: str,
                       shape_chw: Tuple[int, int, int], dtype) -> float:
        if not transform_feasible(src, dst, shape_chw):
            return float("inf")
        bshape = bucket_shape(shape_chw, self.policy)
        v = self.profile.get(transform_cost_key(src, dst, bshape))
        if v is not None:
            self.table_hits += 1
            return v
        self.fallback_hits += 1
        return self.fallback.transform_cost(src, dst, shape_chw, dtype)

    # -----------------------------------------------------------------
    def _fused_cost(self, kind: str, prim: Primitive, scn: Scenario,
                    layout: str) -> float:
        """Measured fused-edge delta from the profile's fused-pair
        entries (``fuse{in,out}::…``, timed by the sweep with
        :func:`~repro_torch.core.costs.measure_fused_primitive`): whole fused
        invocation minus the native invocation, clamped at zero.  Falls
        back to the fallback model's estimate when either entry is
        uncovered — selection never fails on partial coverage.
        """
        if any(t in prim.tags for t in self.exclude_tags):
            return float("inf")
        native = prim.l_in if kind == "in" else prim.l_out
        shape = scn.in_shape_chw if kind == "in" else scn.out_shape_chw
        if layout == native:
            return 0.0
        if not transform_feasible(layout, native, shape):
            return float("inf")
        b = bucket_scenario(scn.with_(n=1), self.policy)
        fused = self.profile.get(fused_cost_key(kind, prim.name, layout, b))
        nat = self.profile.get(prim_cost_key(prim.name, b))
        if fused is not None and nat is not None:
            self.table_hits += 1
            return max(0.0, fused - nat)
        self.fallback_hits += 1
        if kind == "in":
            return self.fallback.fused_in_cost(prim, scn, layout)
        return self.fallback.fused_out_cost(prim, scn, layout)

    def fused_in_cost(self, prim: Primitive, scn: Scenario,
                      l_src: str) -> float:
        return self._fused_cost("in", prim, scn, l_src)

    def fused_out_cost(self, prim: Primitive, scn: Scenario,
                       l_dst: str) -> float:
        return self._fused_cost("out", prim, scn, l_dst)

    # -----------------------------------------------------------------
    def collective_cost(self, kind: str, nbytes: float, n: int) -> float:
        """Measured collective timings when the profile has them.

        Payload sizes bucket to the next power of two (the same
        round-up-only discipline request shapes get, via
        :func:`~repro_torch.serving.bucketing.round_dim`), so log-many
        ``coll::`` entries price every tensor serving or sharding
        selection can produce.  The calibration sweep does not yet
        *measure* collectives (that needs a multi-device run);
        entries arrive from a multi-device timing pass loaded into the
        profile by hand or by future tooling.  Uncovered (kind, bucket,
        n) triples fall back to the fallback model's analytic ring
        estimate — collective pricing never fails on partial coverage.
        """
        if n <= 1:
            return 0.0
        from ..serving.bucketing import round_dim
        bucket = round_dim(int(nbytes), "pow2", 1, 1, 1 << 62)
        v = self.profile.get(collective_cost_key(kind, bucket, n))
        if v is not None:
            self.table_hits += 1
            return v
        self.fallback_hits += 1
        return self.fallback.collective_cost(kind, nbytes, n)

    # -----------------------------------------------------------------
    def coverage(self) -> dict:
        """Lookup accounting since construction (for logs/benchmarks)."""
        total = self.table_hits + self.fallback_hits
        return {"table_hits": self.table_hits,
                "fallback_hits": self.fallback_hits,
                "table_rate": self.table_hits / total if total else 0.0}
