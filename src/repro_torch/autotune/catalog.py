"""VariantCatalog: the versioned artifact of one tuning run.

A catalog records, per generated variant: its kernel package, its
parameters, its per-bucket costs, and whether dominance pruning kept
it.  Like a :class:`~repro.calibrate.profile.HardwareProfile` it is
stamped with the device fingerprint and the *base* registry hash (the
hand-written library it extends), and exposes a ``content_hash`` —
``install()`` passes that hash as the registry extension token, which
``CostModel.version()`` folds into every serving plan-cache key, so
cached plans invalidate whenever the variant set changes.

Kernel-only spaces (flash attention, layout transforms) contribute
``kernels`` entries: the winning parameters per bucket, for the ops
layer to consult — they are not registered with PBQP.
"""
from __future__ import annotations

import datetime
import hashlib
import json
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List

from ..core.ioutil import atomic_write_text
from ..core.primitives import (
    Primitive, build_registry, register_extension, unregister_extension,
)
from .generate import spaces

__all__ = ["CATALOG_SCHEMA", "VariantCatalog", "base_registry_hash",
           "EXTENSION_NAME"]

#: bump when the payload layout or the meaning of entries changes
CATALOG_SCHEMA = 1

#: registry extension slot catalogs install into
EXTENSION_NAME = "autotune"


def base_registry_hash() -> str:
    """Hash of the hand-written registry (without extensions) — the
    library a catalog's variants were tuned against."""
    h = hashlib.sha256()
    for p in sorted(build_registry(), key=lambda p: p.name):
        h.update(f"{p.name}|{p.family}|{p.l_in}|{p.l_out}"
                 f"|{','.join(sorted(p.tags))}\n".encode())
    return h.hexdigest()[:16]


@dataclass
class VariantCatalog:
    """Winners (and pruned losers, for the record) of one tuning run."""

    device: str
    registry: str
    schema: int = CATALOG_SCHEMA
    created: str = ""
    #: how candidates were priced: "real" (measured) or "analytic"
    measure: str = "analytic"
    #: variant name -> {kernel, params, pruned, pruned_by, costs}
    variants: Dict[str, Dict] = field(default_factory=dict)
    #: kernel-only winners: "<kernel>::<bucket>" -> {params, seconds}
    kernels: Dict[str, Dict] = field(default_factory=dict)

    # -----------------------------------------------------------------
    @classmethod
    def new(cls, *, device: str, measure: str = "analytic"
            ) -> "VariantCatalog":
        return cls(device=device, registry=base_registry_hash(),
                   created=datetime.datetime.now(datetime.timezone.utc)
                   .isoformat(timespec="seconds"),
                   measure=measure)

    # -----------------------------------------------------------------
    def survivors(self) -> List[str]:
        return sorted(n for n, e in self.variants.items()
                      if not e.get("pruned") and e.get("costs"))

    def build_primitives(self) -> List[Primitive]:
        """Reconstruct the surviving variants' Primitive objects from
        their recorded parameters via the declaring spaces."""
        sp = spaces()
        out = []
        for name in self.survivors():
            e = self.variants[name]
            space = sp[e["kernel"]]
            prim = space.make_primitive(
                {k: int(v) for k, v in e["params"].items()})
            if prim.name != name:
                raise ValueError(
                    f"catalog variant {name!r} rebuilt as {prim.name!r}; "
                    f"parameter spaces changed — re-run the tuner")
            out.append(prim)
        return out

    def install(self) -> int:
        """Register the surviving variants; returns how many.

        The extension token is the catalog content hash: every
        ``CostModel.version()`` — and therefore every serving
        plan-cache key — moves with the catalog.
        """
        prims = self.build_primitives()
        register_extension(EXTENSION_NAME, prims,
                           token=self.content_hash())
        return len(prims)

    @staticmethod
    def uninstall() -> bool:
        return unregister_extension(EXTENSION_NAME)

    # -----------------------------------------------------------------
    def content_hash(self) -> str:
        h = hashlib.sha256()
        h.update(f"{self.schema}|{self.device}|{self.registry}"
                 f"|{self.measure}".encode())
        for n in sorted(self.variants):
            e = self.variants[n]
            h.update(f"{n}|{e.get('pruned')}|"
                     f"{json.dumps(e.get('params'), sort_keys=True)}|"
                     f"{json.dumps(e.get('costs'), sort_keys=True)}\n"
                     .encode())
        for k in sorted(self.kernels):
            h.update(f"{k}|{json.dumps(self.kernels[k], sort_keys=True)}\n"
                     .encode())
        return h.hexdigest()[:16]

    # -----------------------------------------------------------------
    def to_payload(self) -> Dict:
        return {
            "schema": self.schema,
            "device": self.device,
            "registry": self.registry,
            "created": self.created,
            "measure": self.measure,
            "variants": {k: self.variants[k]
                         for k in sorted(self.variants)},
            "kernels": {k: self.kernels[k] for k in sorted(self.kernels)},
        }

    @classmethod
    def from_payload(cls, payload: Dict) -> "VariantCatalog":
        if payload.get("schema") != CATALOG_SCHEMA:
            raise ValueError(
                f"catalog schema {payload.get('schema')!r} != "
                f"{CATALOG_SCHEMA}; re-run the tuner")
        return cls(device=str(payload["device"]),
                   registry=str(payload["registry"]),
                   schema=int(payload["schema"]),
                   created=str(payload.get("created", "")),
                   measure=str(payload.get("measure", "analytic")),
                   variants=dict(payload.get("variants", {})),
                   kernels=dict(payload.get("kernels", {})))

    def save(self, path) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        atomic_write_text(p, json.dumps(self.to_payload(), indent=1))

    @classmethod
    def load(cls, path) -> "VariantCatalog":
        return cls.from_payload(json.loads(pathlib.Path(path).read_text()))
