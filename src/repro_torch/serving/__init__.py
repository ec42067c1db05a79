"""Serving-side helpers of the port.

Only scenario bucketing is ported so far (``bucketing.py``, a verbatim
copy of the reference's): the calibration sweep and
``calibrate.CalibratedCostModel`` canonicalize scenarios with it.  The
reference's ``serving/__init__`` also imports the plan server, which is
not ported yet, so this package exports the bucketing names alone.
"""
from .bucketing import (BucketPolicy, bucket_key, bucket_scenario,
                        bucket_shape, round_dim)

__all__ = ["BucketPolicy", "bucket_scenario", "bucket_shape", "bucket_key",
           "round_dim"]
