"""Plain PyTorch forward of a CNN described by a configuration's ``layers``
list, and its weights drawn again from the seed.

The list is a graph of named layers: an entry takes the outputs that its
``inputs`` names, or else the entry before it's (``bench/work.py``'s
rule, whose ``layers`` walks the shapes for both functions here), so a
list without ``inputs`` is a sequential network and one with them may
branch and join, as GoogLeNet's inception modules do.

The reference that decides ``correct``: float32 with TF32 off for
cuBLAS and cuDNN (``precision("f32")``), one library call per layer, no
batching tricks, no cache.  ``precision("tf32")`` is the control: the
same forward one precision below what the configurations state.  It
imports nothing of the program.

Departures from the published networks are the configurations' own and
are shared with the program: AlexNet runs as one tower (its source
splits conv2, conv4 and conv5 into two groups over two GPUs).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

import work


def init_params(layers: Sequence[Dict], in_shape: Sequence[int],
                seed: int) -> List[Dict[str, np.ndarray]]:
    """He-initialised weights, drawn in list order from one numpy
    generator seeded with ``seed``: a conv's weights (M, C, K, K) from
    N(0, 2 / (C K K)) and its bias from N(0, 0.01); an fc layer's weights
    (inputs, features) from N(0, 2 / inputs) and a zero bias.  Layers
    without weights draw nothing."""
    rng = np.random.default_rng(seed)
    params: List[Dict[str, np.ndarray]] = []
    for l in work.layers(layers, in_shape):
        s, p = l.spec, {}
        if l.op == "conv":
            c, k, m = l.in_shape[0], s["k"], s["m"]
            std = float(np.sqrt(2.0 / (c * k * k)))
            p["w"] = rng.normal(0, std, size=(m, c, k, k)).astype(np.float32)
            p["b"] = rng.normal(0, 0.01, size=(m,)).astype(np.float32)
        elif l.op == "fc":
            n_in = math.prod(l.in_shape)
            std = float(np.sqrt(2.0 / n_in))
            p["w"] = rng.normal(0, std, size=(n_in, s["features"])) \
                .astype(np.float32)
            p["b"] = np.zeros((s["features"],), np.float32)
        params.append(p)
    return params


def to_device(params: List[Dict[str, np.ndarray]],
              device) -> List[Dict[str, torch.Tensor]]:
    return [{k: torch.from_numpy(v).to(device) for k, v in p.items()}
            for p in params]


@contextlib.contextmanager
def precision(name: str):
    """``"f32"``: TF32 off for matmul and cuDNN; ``"tf32"``: on (the
    control).  Restores the flags on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = {"f32": False, "tf32": True}[name]
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def forward(layers: Sequence[Dict], params: List[Dict[str, torch.Tensor]],
            x: torch.Tensor) -> torch.Tensor:
    """Outputs (N, features) of images ``x`` (N, C, H, W): the last
    entry's.  An output is dropped after the last entry that takes it."""
    ls = work.layers(layers, x.shape[1:])
    last = {n: i for i, l in enumerate(ls) for n in l.inputs}
    outs: Dict[str, torch.Tensor] = {}
    for i, (l, p) in enumerate(zip(ls, params)):
        s, op = l.spec, l.op
        xs = [outs[n] for n in l.inputs] or [x]
        y = torch.cat(xs, dim=1) if op == "concat" else xs[0]
        if op == "conv":
            y = F.conv2d(y, p["w"], p["b"], stride=s.get("stride", 1),
                         padding=s.get("pad", 0))
        elif op == "relu":
            y = F.relu(y)
        elif op == "lrn":
            y = F.local_response_norm(y, s["size"], alpha=s["alpha"],
                                      beta=s["beta"], k=s["bias"])
        elif op == "maxpool":  # padding reads as -inf
            y = F.max_pool2d(y, s["k"], s["stride"], s.get("pad", 0))
        elif op == "gap":
            y = y.mean(dim=(2, 3), keepdim=True)
        elif op == "fc":
            y = y.flatten(1) @ p["w"] + p["b"]
            if s.get("relu"):
                y = F.relu(y)
        elif op == "softmax":
            y = torch.softmax(y.flatten(1), dim=1)
        outs[l.name] = y
        for n in l.inputs:
            if last[n] == i:
                del outs[n]
    return y.flatten(1)


def run(layers: Sequence[Dict], params: List[Dict[str, torch.Tensor]],
        images: np.ndarray, device, *, block: int,
        prec: str = "f32") -> np.ndarray:
    """The reference's outputs for ``images`` (N, C, H, W) on ``device``,
    computed in blocks of ``block`` images, as float64 on the host."""
    out = []
    with torch.no_grad(), precision(prec):
        for i in range(0, len(images), block):
            x = torch.from_numpy(np.ascontiguousarray(
                images[i:i + block])).to(device)
            out.append(forward(layers, params, x).double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, 0))


#: probabilities below this count as this in the comparison: far below
#: anything float32 rounds, far above where its exponentials underflow
P_FLOOR = 1e-30


def max_logit_err(got: np.ndarray, want: np.ndarray) -> float:
    """The widest relative gap between the logits that two sets of
    probability rows imply: for each row, log-probabilities (floored at
    ``P_FLOOR``) less their mean, |got - want| / |want| in L2; the
    largest over the rows.  A softmax that saturates hides a gap in its
    probabilities, not in their logarithms."""
    def centred(p):
        lp = np.log(np.maximum(np.asarray(p, np.float64)
                               .reshape(len(want), -1), P_FLOOR))
        return lp - lp.mean(axis=1, keepdims=True)
    g, w = centred(got), centred(want)
    num = np.linalg.norm(g - w, axis=1)
    den = np.linalg.norm(w, axis=1)
    return float(np.max(num / den)) if len(want) else math.nan
