"""Fault-tolerant checkpointing: atomic, resumable, rotation-managed
(port of the reference's ``checkpoint/checkpointer.py``, the same files).

Layout:  <dir>/step_<n>/arrays.npz + meta.json, written to step_<n>.tmp
and renamed into place, so a node failure mid-write never corrupts the
latest checkpoint; the oldest beyond ``keep`` are deleted.  Leaf ``i``
is ``a{i}`` in ``arrays.npz`` (``a{i}__bf16`` holds a bf16 leaf as f32),
in ``jax.tree.flatten``'s order (``repro_torch.tree``), so a
checkpoint written by either package restores in the other:
:meth:`Checkpointer.restore` reads the leaves into the structure of
``like``.  ``meta.json`` holds the reference's keys except
``treedef``, a string that the reference writes and neither package
reads.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import tree as pytree

__all__ = ["Checkpointer"]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        leaves = pytree.leaves(tree)
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        arrays = {}
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach()
                if leaf.dtype == torch.bfloat16:
                    arrays[f"a{i}__bf16"] = leaf.float().cpu().numpy()
                    continue
                leaf = leaf.cpu().numpy()
            arrays[f"a{i}"] = np.asarray(leaf)
        np.savez(tmp / "arrays.npz", **arrays)
        meta = {"step": step, "n_leaves": len(leaves), "time": time.time(),
                "extra": extra or {}}
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)   # atomic commit
        self._rotate()

    def _rotate(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not p.is_dir():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: Optional[int] = None
                ) -> Tuple[int, Any, Dict]:
        """Restore into the structure, dtypes and devices of ``like``'s
        tensors."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        final = self.dir / f"step_{step}"
        meta = json.loads((final / "meta.json").read_text())
        leaves_like = pytree.leaves(like)
        leaves = []
        with np.load(final / "arrays.npz") as data:
            for i, ref in enumerate(leaves_like):
                if f"a{i}__bf16" in data:
                    arr = torch.from_numpy(data[f"a{i}__bf16"]).to(
                        torch.bfloat16)
                else:
                    arr = torch.from_numpy(data[f"a{i}"])
                if isinstance(ref, torch.Tensor):
                    arr = arr.to(device=ref.device, dtype=ref.dtype)
                leaves.append(arr)
        return meta["step"], pytree.unflatten(like, leaves), meta["extra"]
