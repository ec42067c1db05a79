"""Plain PyTorch forward of a sequential CNN described by a configuration's
``layers`` list, and its weights drawn again from the seed.

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


def init_params(layers: Sequence[Dict], in_shape: Sequence[int],
                seed: int) -> List[Dict[str, np.ndarray]]:
    """He-initialised weights, drawn in layer order from one numpy
    generator seeded with ``seed``: a conv's weights (M, C, K, K) from
    N(0, 2 / (C K K)) and its bias from N(0, 0.01); an fc layer's weights
    (inputs, features) from N(0, 2 / inputs) and a zero bias.  Layers
    without weights draw nothing."""
    rng = np.random.default_rng(seed)
    c, h, w = (int(v) for v in in_shape)
    params: List[Dict[str, np.ndarray]] = []
    for s in layers:
        p: Dict[str, np.ndarray] = {}
        if s["op"] == "conv":
            k, m = s["k"], s["m"]
            std = float(np.sqrt(2.0 / (c * k * k)))
            p["w"] = rng.normal(0, std, size=(m, c, k, k)).astype(np.float32)
            p["b"] = rng.normal(0, 0.01, size=(m,)).astype(np.float32)
            st, pad = s.get("stride", 1), s.get("pad", 0)
            c, h, w = m, (h + 2 * pad - k) // st + 1, (w + 2 * pad - k) // st + 1
        elif s["op"] == "fc":
            n_in = c * h * w
            std = float(np.sqrt(2.0 / n_in))
            p["w"] = rng.normal(0, std, size=(n_in, s["features"])) \
                .astype(np.float32)
            p["b"] = np.zeros((s["features"],), np.float32)
            c, h, w = s["features"], 1, 1
        elif s["op"] == "maxpool":
            h, w = (h - s["k"]) // s["stride"] + 1, \
                (w - s["k"]) // s["stride"] + 1
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
    """Outputs (N, features) of images ``x`` (N, C, H, W)."""
    for s, p in zip(layers, params):
        op = s["op"]
        if op == "conv":
            x = F.conv2d(x, p["w"], p["b"], stride=s.get("stride", 1),
                         padding=s.get("pad", 0))
        elif op == "relu":
            x = F.relu(x)
        elif op == "lrn":
            x = F.local_response_norm(x, s["size"], alpha=s["alpha"],
                                      beta=s["beta"], k=s["bias"])
        elif op == "maxpool":
            x = F.max_pool2d(x, s["k"], s["stride"])
        elif op == "fc":
            x = x.flatten(1) @ p["w"] + p["b"]
            if s.get("relu"):
                x = F.relu(x)
        elif op == "softmax":
            x = torch.softmax(x.flatten(1), dim=1)
        else:
            raise ValueError(f"unknown layer op {op!r}")
    return x.flatten(1)


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
