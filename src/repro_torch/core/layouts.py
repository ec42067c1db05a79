"""Data layouts and the data-layout-transformation (DT) graph.

Section 3.1 of the paper: the set of direct layout-transformation
routines forms a directed graph over layouts.  Chains of transformations
give the transitive closure; the cost of converting layout A -> B is the
shortest path in the DT graph under per-edge costs (measured execution
time of each direct transform on the actual tensor sizes).  Unreachable
pairs have infinite cost.

Layouts here are permutations of the logical (C, H, W) activation tensor
axes, plus *blocked* variants (e.g. HWC8 = H x W x C/8 x 8, the vector-
friendly blocking used by vectorised primitives).  On TPU the same
machinery is reused at the distributed level where "layouts" are
shardings — see repro/core/sharding_select.py.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Layout",
    "CHW", "CWH", "HCW", "HWC", "WCH", "WHC", "HWC8",
    "ALL_LAYOUTS",
    "DTGraph",
    "default_dt_graph",
]


@dataclass(frozen=True)
class Layout:
    """A concrete in-memory arrangement of a logical (C, H, W) tensor.

    ``perm[i]`` is the logical axis (0=C, 1=H, 2=W) stored at memory
    position ``i``; i.e. ``mem = np.transpose(x_chw, perm)``.
    ``block_c`` > 0 means the C axis
    is additionally blocked into (C // block_c, ..., block_c) with the
    block innermost (vector-register friendly; the analogue of the
    NCHWc layouts used by MKL-DNN / oneDNN).
    """

    name: str
    perm: Tuple[int, int, int]  # logical axis stored at each memory position
    block_c: int = 0

    def to_memory(self, x_chw: np.ndarray) -> np.ndarray:
        """Convert a logical CHW array into this layout (reference impl)."""
        x = np.transpose(x_chw, self.perm)
        if self.block_c:
            # find where C sits in memory order
            cpos = self.perm.index(0)
            c = x.shape[cpos]
            if c % self.block_c:
                raise ValueError(f"C={c} not divisible by block {self.block_c}")
            shape = list(x.shape)
            shape[cpos:cpos + 1] = [c // self.block_c, self.block_c]
            x = x.reshape(shape)
            # move the block axis innermost
            x = np.moveaxis(x, cpos + 1, -1)
        return x

    def from_memory(self, x_mem: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`to_memory` — back to logical CHW."""
        x = x_mem
        if self.block_c:
            cpos = self.perm.index(0)
            x = np.moveaxis(x, -1, cpos + 1)
            shape = list(x.shape)
            shape[cpos:cpos + 2] = [shape[cpos] * shape[cpos + 1]]
            x = x.reshape(shape)
        inv = np.argsort(self.perm)
        return np.transpose(x, inv)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Layout({self.name})"


_AXES = "CHW"


def _perm_layout(order: str) -> Layout:
    return Layout(order, tuple(_AXES.index(a) for a in order))


CHW = _perm_layout("CHW")
CWH = _perm_layout("CWH")
HCW = _perm_layout("HCW")
HWC = _perm_layout("HWC")
WCH = _perm_layout("WCH")
WHC = _perm_layout("WHC")
HWC8 = Layout("HWC8", HWC.perm, block_c=8)

#: the paper's three main layouts + blocked variant; CWH/WCH/WHC exist in
#: the DT graph but no primitive uses them natively (they exercise the
#: "chain of transformations" path).
ALL_LAYOUTS: List[Layout] = [CHW, HCW, HWC, CWH, WCH, WHC, HWC8]
LAYOUT_BY_NAME: Dict[str, Layout] = {l.name: l for l in ALL_LAYOUTS}


def transform_feasible(src: str, dst: str,
                       shape_chw: Tuple[int, int, int]) -> bool:
    """Blocked layouts require the channel count to divide the block."""
    for name in (src, dst):
        lay = LAYOUT_BY_NAME.get(name)
        if lay is not None and lay.block_c and shape_chw[0] % lay.block_c:
            return False
    return True


class DTGraph:
    """Data-layout transformation graph with APSP cost/chain queries.

    Nodes: layout names.  Directed edges: direct transformation routines
    with a cost function ``(scenario) -> seconds`` (or a constant).  The
    all-pairs shortest path is computed lazily per cost key and cached.
    """

    def __init__(self) -> None:
        self._nodes: List[str] = []
        self._edges: Dict[Tuple[str, str], Callable] = {}

    def add_layout(self, name: str) -> None:
        if name not in self._nodes:
            self._nodes.append(name)

    def add_transform(self, src: str, dst: str, cost_fn: Callable) -> None:
        """Register a direct transform routine src -> dst.

        ``cost_fn(shape_chw, dtype) -> float`` returns the (profiled or
        modelled) execution cost for a logical-CHW shaped tensor.
        """
        self.add_layout(src)
        self.add_layout(dst)
        self._edges[(src, dst)] = cost_fn

    @property
    def layouts(self) -> List[str]:
        return list(self._nodes)

    @property
    def direct_edges(self) -> List[Tuple[str, str]]:
        return list(self._edges)

    # ------------------------------------------------------------------
    def cost_matrix(self, shape_chw: Tuple[int, int, int],
                    dtype=np.float32) -> Tuple[np.ndarray, Dict[str, int]]:
        """APSP cost matrix for converting a tensor of this shape.

        Returns ``(costs, index)`` where ``costs[i, j]`` is the min total
        cost of converting layout i -> j (0 on the diagonal, inf if
        unreachable) and ``index`` maps layout name -> row.
        """
        idx = {n: i for i, n in enumerate(self._nodes)}
        n = len(self._nodes)
        d = np.full((n, n), np.inf)
        np.fill_diagonal(d, 0.0)
        for (s, t), fn in self._edges.items():
            c = float(fn(shape_chw, dtype))
            if c < d[idx[s], idx[t]]:
                d[idx[s], idx[t]] = c
        # Floyd-Warshall (layout count is tiny)
        for k in range(n):
            d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
        return d, idx

    def shortest_chain(self, src: str, dst: str,
                       shape_chw: Tuple[int, int, int],
                       dtype=np.float32) -> Optional[List[str]]:
        """The actual layout chain realising the APSP cost (for the
        legalizer, which must materialise conversion layers)."""
        if src == dst:
            return [src]
        idx = {n: i for i, n in enumerate(self._nodes)}
        n = len(self._nodes)
        d = np.full((n, n), np.inf)
        np.fill_diagonal(d, 0.0)
        nxt = -np.ones((n, n), dtype=np.int64)
        for (s, t), fn in self._edges.items():
            c = float(fn(shape_chw, dtype))
            si, ti = idx[s], idx[t]
            if c < d[si, ti]:
                d[si, ti] = c
                nxt[si, ti] = ti
        for i in range(n):
            nxt[i, i] = i
        for k in range(n):
            for i in range(n):
                for j in range(n):
                    if d[i, k] + d[k, j] < d[i, j]:
                        d[i, j] = d[i, k] + d[k, j]
                        nxt[i, j] = nxt[i, k]
        si, ti = idx[src], idx[dst]
        if not np.isfinite(d[si, ti]):
            return None
        path = [si]
        while path[-1] != ti:
            path.append(int(nxt[path[-1], ti]))
        names = self._nodes
        return [names[p] for p in path]


# ----------------------------------------------------------------------
# default DT graph: transforms between the permutation layouts
# ----------------------------------------------------------------------
def _transpose_cost(shape_chw, dtype, *, passes: float = 1.0) -> float:
    """Analytic fallback cost of a layout transform: bytes moved twice
    (read + write) at an effective strided-copy bandwidth."""
    c, h, w = shape_chw
    nbytes = c * h * w * np.dtype(dtype).itemsize
    eff_bw = 4e9  # strided transpose is far from streaming bandwidth
    return passes * 2 * nbytes / eff_bw


def default_dt_graph(profile: bool = False) -> DTGraph:
    """The DT graph shipped with the primitive library.

    Deliberately *not* complete: CHW <-> HWC and CHW <-> HCW have direct
    routines, but e.g. HWC -> HCW must chain through CHW, and the blocked
    HWC8 layout is reachable only from HWC.  This mirrors the paper's
    observation that real libraries provide a limited set of direct
    transforms and chains must be constructed.
    """
    g = DTGraph()
    direct = [
        ("CHW", "HWC"), ("HWC", "CHW"),
        ("CHW", "HCW"), ("HCW", "CHW"),
        ("CHW", "CWH"), ("CWH", "CHW"),
        ("HWC", "WHC"), ("WHC", "HWC"),
        ("CWH", "WCH"), ("WCH", "CWH"),
        ("HWC", "HWC8"), ("HWC8", "HWC"),
    ]
    for s, t in direct:
        g.add_transform(s, t, _transpose_cost)
    return g
