"""Scenario bucketing: canonicalize a stream of request shapes.

The paper solves primitive selection once, offline, for a fixed scenario
tuple {C, H, W, delta, K, M}.  A server sees *arbitrary* input shapes; a
separate PBQP solve + kernel compile per exact shape would make plan
count (and XLA executable count) grow without bound.  Bucketing rounds
every incoming (C, H, W) request shape up to a canonical bucket shape —
by default to powers of two, clamped to a configurable range — so the
set of distinct plans stays small and every request maps onto one.

Rounding is always *up*: a request is embedded into its bucket by zero
padding (never cropped), so the bucketed network dominates the request
spatially.  A shape larger than ``max_*`` keeps its rounded value rather
than being cropped — boundedness is a traffic assumption, correctness is
not negotiable.

The bucket is also the serving stack's *co-batching equivalence
relation*: requests sharing a bucket shape can share one batched
executable invocation, which is what :meth:`~repro.serving.server.
PlanServer.infer_batch` groups by and what the continuous scheduler
(:mod:`repro.serving.scheduler`) keys its pending queues on — so
``max_n`` doubles as the scheduler's full-group launch threshold, and
``bucket_n`` prices the batch a group *would* launch at when its
deadline slack is evaluated (docs/serving.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ..core.scenario import Scenario

__all__ = ["BucketPolicy", "bucket_shape", "bucket_key", "round_dim",
           "bucket_scenario"]


def _next_pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def _round_up(v: int, mode: str, step: int, lo: int, hi: int) -> int:
    if mode == "exact":
        return max(v, 1)
    if mode == "pow2":
        r = _next_pow2(max(v, lo))
    elif mode == "linear":
        r = -(-max(v, lo) // step) * step
    else:
        raise ValueError(f"unknown bucketing mode {mode!r}")
    # clamp to the configured ceiling, but never below the request itself
    return max(min(r, hi), v)


@dataclass(frozen=True)
class BucketPolicy:
    """How request shapes collapse into buckets.

    ``spatial`` / ``channel`` / ``batch`` modes: ``"pow2"`` (round up to
    a power of two — log-many buckets over any traffic), ``"linear"``
    (round up to a multiple of ``*_step``), ``"exact"`` (no rounding;
    one bucket per distinct shape — plan count unbounded, useful for
    benchmarks).

    The ``batch`` axis buckets minibatch sizes the same way spatial
    dims bucket: a group of N coalesced same-bucket requests runs on
    the executable compiled for the N-bucket (zero rows pad the batch),
    so the number of distinct batched executables stays logarithmic in
    the largest batch.  Like every other axis, rounding never goes
    *down*: a batch above ``max_n`` keeps its own size rather than
    being clamped (boundedness is a traffic assumption — the server's
    ``infer_batch`` chunks groups at ``max_n``, so it never requests
    such a bucket; correctness is not negotiable).
    """

    spatial: str = "pow2"
    channel: str = "pow2"
    batch: str = "pow2"
    spatial_step: int = 32
    channel_step: int = 16
    batch_step: int = 4
    min_hw: int = 8
    max_hw: int = 512
    min_c: int = 1
    max_c: int = 1024
    min_n: int = 1
    max_n: int = 64

    def bucket(self, shape_chw: Tuple[int, int, int]) -> Tuple[int, int, int]:
        return bucket_shape(shape_chw, self)

    def bucket_n(self, n: int) -> int:
        """Canonical batch bucket for a group of ``n`` requests
        (round-up-only, like :func:`bucket_shape`: above ``max_n`` the
        request's own size wins — clamping *down* would price or
        compile a smaller batch than is actually running).
        """
        if n < 1:
            raise ValueError(f"bad batch size {n}")
        return _round_up(n, self.batch, self.batch_step,
                         self.min_n, self.max_n)


def bucket_shape(shape_chw: Tuple[int, int, int],
                 policy: BucketPolicy) -> Tuple[int, int, int]:
    """Canonical bucket shape (>= request in every dimension)."""
    c, h, w = (int(v) for v in shape_chw)
    if min(c, h, w) < 1:
        raise ValueError(f"bad request shape {shape_chw}")
    return (
        _round_up(c, policy.channel, policy.channel_step,
                  policy.min_c, policy.max_c),
        _round_up(h, policy.spatial, policy.spatial_step,
                  policy.min_hw, policy.max_hw),
        _round_up(w, policy.spatial, policy.spatial_step,
                  policy.min_hw, policy.max_hw),
    )


def bucket_key(bucket_chw: Tuple[int, int, int], n: int = 1) -> str:
    """Human-readable stable key for a bucket (used in cache file names).

    The batch bucket is appended only for ``n > 1`` so single-image keys
    (and the plans persisted under them before the batch axis existed)
    are unchanged.
    """
    c, h, w = bucket_chw
    base = f"c{c}h{h}w{w}"
    return base if n == 1 else f"{base}n{n}"


def round_dim(v: int, mode: str, step: int, lo: int, hi: int) -> int:
    """Round one dimension up under a bucketing mode (public helper).

    Same semantics as the per-axis rounding inside :func:`bucket_shape`:
    never below the request value, clamped to ``hi`` only when the
    request itself fits under it.
    """
    return _round_up(v, mode, step, lo, hi)


def bucket_scenario(scn: Scenario, policy: BucketPolicy) -> Scenario:
    """Canonicalize a convolution scenario into its calibration bucket.

    The spatial/channel input dimensions round up exactly like request
    shapes (:func:`bucket_shape`); the output-channel count M rounds
    under the channel mode; the minibatch rounds under the batch mode
    (:meth:`BucketPolicy.bucket_n`).  Stride, kernel radix, padding and
    dtype are preserved — they change which primitives even apply, so
    they are bucket identity, not something to round.  Used by
    :class:`repro.calibrate.CalibratedCostModel` to map arbitrary
    per-layer scenarios onto the finite grid a
    :class:`~repro.calibrate.HardwareProfile` was measured on.
    """
    c, h, w = bucket_shape(scn.in_shape_chw, policy)
    m = round_dim(scn.m, policy.channel, policy.channel_step,
                  policy.min_c, policy.max_c)
    return scn.with_(c=c, h=h, w=w, m=m, n=policy.bucket_n(scn.n))
