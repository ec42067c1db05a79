"""HardwareProfile: versioned per-device cost tables on disk.

Port of the reference's ``calibrate/profile.py``.  A profile is the
artifact of one calibration sweep (``python -m
repro_torch.launch.calibrate``): a flat table mapping measurement keys to
seconds, stamped with everything needed to decide whether the numbers
are trustworthy *here and now*:

* ``device`` — fingerprint of the device the sweep ran on.  On a card:
  ``cuda:<name, spaces as _>:sm<major><minor>:n<device count>``, from
  ``torch.cuda``; on the CPU: ``cpu:cpu:n1``.  A profile measured on one
  device class must not silently price another.
* ``registry`` — hash of the primitive registry (names, families,
  layouts, tags) at calibration time.  It runs over the port's registry
  and differs from the reference's hash: the port tags its kernel
  primitives ``kernel`` where the reference has ``tpu-only``.
* ``schema`` — bumped when the entry key format or units change; equal
  to the reference's, and the payload is the same, so a profile written
  by one package loads in the other.

Entry keys are exactly the :mod:`repro_torch.core.costs` cache keys
(``prim::<name>::<scenario-key>`` and ``dt::<src>-><dst>::<CxHxW>``),
plus ``kernel::<name>::<scenario-key>`` for the standalone kernel
microbenchmarks.

:meth:`HardwareProfile.content_hash` digests the whole table; the
:class:`~repro_torch.calibrate.model.CalibratedCostModel` folds it into
``CostModel.version()``.
"""
from __future__ import annotations

import datetime
import hashlib
import json
import pathlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

from ..core.ioutil import atomic_write_text
from ..kernels.common import resolve_device

__all__ = ["PROFILE_SCHEMA", "HardwareProfile", "device_fingerprint",
           "registry_hash"]

#: bump when the entry key format or the units of values change
PROFILE_SCHEMA = 1


def device_fingerprint(device=None) -> str:
    """Stable id of the device a sweep on ``device`` measures on (the
    card unless told otherwise; raises without one)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return f"{dev.type}:{dev.type}:n1"
    import torch
    name = torch.cuda.get_device_name(dev).replace(" ", "_")
    major, minor = torch.cuda.get_device_capability(dev)
    return f"cuda:{name}:sm{major}{minor}:n{torch.cuda.device_count()}"


def registry_hash() -> str:
    """Content hash of the primitive registry (coverage identity)."""
    from ..core.primitives import registry
    h = hashlib.sha256()
    for p in sorted(registry(), key=lambda p: p.name):
        h.update(f"{p.name}|{p.family}|{p.l_in}|{p.l_out}"
                 f"|{','.join(sorted(p.tags))}\n".encode())
    return h.hexdigest()[:16]


@dataclass
class HardwareProfile:
    """One device's measured cost table (see module docstring)."""

    device: str
    registry: str
    schema: int = PROFILE_SCHEMA
    created: str = ""
    #: measurement discipline the sweep used (recorded for reproduction)
    reps: int = 3
    min_time: float = 5e-3
    #: measurement key -> seconds
    entries: Dict[str, float] = field(default_factory=dict)

    # -----------------------------------------------------------------
    @classmethod
    def new(cls, *, reps: int = 3, min_time: float = 5e-3,
            device: Optional[str] = None) -> "HardwareProfile":
        """Fresh empty profile stamped ``device`` (a fingerprint), by
        default the card's (:func:`device_fingerprint`)."""
        return cls(device=device or device_fingerprint(),
                   registry=registry_hash(),
                   created=datetime.datetime.now(datetime.timezone.utc)
                   .isoformat(timespec="seconds"),
                   reps=reps, min_time=min_time)

    # -----------------------------------------------------------------
    def get(self, key: str) -> Optional[float]:
        return self.entries.get(key)

    def put(self, key: str, seconds: float) -> None:
        self.entries[key] = float(seconds)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def covered(self, keys: Iterable[str]) -> int:
        return sum(1 for k in keys if k in self.entries)

    # -----------------------------------------------------------------
    def content_hash(self) -> str:
        """Digest of everything that could change a served cost.

        Any new/changed measurement changes this hash, which changes
        ``CalibratedCostModel.version()``, which invalidates persisted
        PBQP plans priced by the old table.
        """
        h = hashlib.sha256()
        h.update(f"{self.schema}|{self.device}|{self.registry}".encode())
        for k in sorted(self.entries):
            h.update(f"{k}={self.entries[k]!r}\n".encode())
        return h.hexdigest()[:16]

    # -----------------------------------------------------------------
    def to_payload(self) -> Dict:
        return {
            "schema": self.schema,
            "device": self.device,
            "registry": self.registry,
            "created": self.created,
            "reps": self.reps,
            "min_time": self.min_time,
            "entries": dict(sorted(self.entries.items())),
        }

    @classmethod
    def from_payload(cls, payload: Dict) -> "HardwareProfile":
        if payload.get("schema") != PROFILE_SCHEMA:
            raise ValueError(
                f"profile schema {payload.get('schema')!r} != "
                f"{PROFILE_SCHEMA}; re-run the calibration sweep")
        return cls(device=str(payload["device"]),
                   registry=str(payload["registry"]),
                   schema=int(payload["schema"]),
                   created=str(payload.get("created", "")),
                   reps=int(payload.get("reps", 3)),
                   min_time=float(payload.get("min_time", 5e-3)),
                   entries={str(k): float(v)
                            for k, v in payload["entries"].items()})

    def save(self, path) -> None:
        """Atomic write with writer-unique tmp names, like every cache
        in the port (``core.ioutil.atomic_write_text``)."""
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        atomic_write_text(p, json.dumps(self.to_payload(), indent=1))

    @classmethod
    def load(cls, path) -> "HardwareProfile":
        return cls.from_payload(json.loads(pathlib.Path(path).read_text()))
