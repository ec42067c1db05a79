"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything that belongs to one configuration, traffic mix, check or
metric is a data file or a reader found by its name:

- ``BENCHMARK.json`` names the cell, its configuration and its traffic;
- ``bench/configs/<config>.json``: the network (by the program's name and
  as a list of named layers with their sizes, which may branch and join:
  ``work.layers``), input shape, dtype, selector, bucket policy, whether
  executables are CUDA graphs, and the scale at which the CPU tests run
  it (``cpu_scale``; a run ignores it);
- ``bench/traffic/<traffic>.json``: the entry the clients drive
  (``infer``, ``infer_batch`` or ``submit``), clients, images per call,
  batch buckets, warm-up requests and which images the check samples;
- ``bench/checks/<cell>.json``: the limit of each number compared;
- ``bench/metrics/<metric>.py``: ``read(ctx)``, the metric's value or None;
- ``bench/reference/<reference>.py``: the plain reference.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import itertools
import json
import pathlib
import sys
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

import load  # noqa: E402
import work  # noqa: E402

#: seconds at the window's start that the traced run traces and reads
#: its per-layer metrics from
PROFILE_S = 3.0
#: seconds a request in flight at the window's close may take to return
GRACE_S = 60.0
#: the port's kernel libraries behind each launch counter
LIB_OF_COUNTER = {"conv_direct": "conv_direct", "conv_im2col": "matmul",
                  "winograd_gemm": "winograd_gemm", "matmul": "matmul",
                  "winograd_transform": "winograd_transform"}


@dataclass
class Spec:
    workload: str
    config: Dict
    traffic: Dict
    checks: Dict
    metrics: List[Dict]


def load_spec(workload: str, trace: bool) -> Spec:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_file = next(c["file"] for c in bench["configs"]
                    if c["name"] == cell["config"])
    config = json.loads((ROOT / cfg_file).read_text())
    traffic = json.loads((BENCH / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    checks = json.loads((BENCH / "checks" / f"{workload}.json").read_text())
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if workload in m.get("workloads", [workload])]
    return Spec(workload, config, traffic, checks, metrics)


def reader(name: str) -> Callable:
    """``read`` of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def arch(layers: List["work.Layer"]) -> List[tuple]:
    """A network's weighted layers, each conv with the (C, H, W) it
    takes, as the program's net must have them."""
    out = []
    for l in layers:
        s = l.spec
        if l.op == "conv":
            out.append((l.name, s["m"], s["k"], s.get("stride", 1),
                        s.get("pad", 0), l.in_shape))
        elif l.op == "fc":
            out.append((l.name, s["features"]))
    return out


def program_arch(net) -> List[tuple]:
    out = []
    for nid in net.order:
        node = net.nodes[nid]
        if node.kind == "conv":
            s = node.scn
            out.append((nid, s.m, s.k, s.stride, s.pad, (s.c, s.h, s.w)))
        elif node.kind == "op" and node.op.name.startswith("fc"):
            out.append((nid, node.out_shape[0]))
    return out


def check_arch(layers: List["work.Layer"], net) -> None:
    """Raises naming the first weighted layer where the configuration's
    network and the program's differ."""
    mine, theirs = arch(layers), program_arch(net)
    for a, b in itertools.zip_longest(mine, theirs):
        if a != b:
            raise RuntimeError(f"the configuration's layer {a} is the "
                               f"program's {net.name} layer {b}")


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", scale: float = 1.0,
        control: bool = False) -> Dict:
    """One run of ``workload``; returns the result line's object.

    ``scale`` and ``device="cpu"`` serve the CPU tests only; ``control``
    also reads the control (the reference in TF32) on the same images.
    """
    spec = load_spec(workload, trace)
    cfg, tr = spec.config, spec.traffic
    pseed = seed % (1 << 63)

    import torch

    from repro_torch.convnets import NETWORKS
    from repro_torch.core import costs
    from repro_torch.kernels import (LAUNCH_COUNTER_OF, conv_launches,
                                     expected_launches)
    from repro_torch.kernels.common import build_all
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving import (BucketPolicy, ContinuousScheduler,
                                     PlanServer)
    split = {"import_s": time.perf_counter() - t_start}

    dev = torch.device(device)
    net = NETWORKS[cfg["network"]](scale)
    in_shape = tuple(net.nodes[net.order[0]].out_shape)
    if scale == 1.0 and list(in_shape) != cfg["input"]:
        raise RuntimeError(f"input {in_shape} is not {cfg['input']}")
    layers = work.layers(cfg["layers"], in_shape)
    check_arch(layers, net)
    peak = work.peak_of(torch.cuda.get_device_name(dev)) \
        if dev.type == "cuda" else None

    sel_cfg = cfg["selector"]
    cost = costs.AnalyticCostModel(getattr(costs, sel_cfg["spec"]),
                                   include_kernels=sel_cfg["include_kernels"])
    policy = BucketPolicy(**cfg["bucket_policy"], **tr["batch"])
    spans: List[Dict] = []
    obs_trace.configure(spans, enabled=True)  # set-up's spans, for the split
    server = PlanServer(lambda _shape: net, cost, policy=policy,
                        params_seed=pseed, jit=cfg["jit"], device=dev,
                        exact=sel_cfg["solver"] == "pbqp")
    sched = None
    clients = None
    try:
        entry, k = tr["entry"], tr["images_per_call"]
        nb = policy.bucket_n(k if entry != "submit" else policy.max_n)
        sel = server.plan_for(in_shape, nb)
        split["solve_s"] = server.stats()["solve_s"]

        t = time.perf_counter()
        prims = {c.primitive.name.split("@")[0]
                 for c in sel.choices.values() if c.primitive is not None}
        libs = sorted({LIB_OF_COUNTER[c] for p in prims
                       for c in conv_launches(p)})
        if dev.type == "cuda":
            mods = [importlib.import_module(f"repro_torch.kernels.{m}.kernel")
                    for m in libs]
            build_all(m.LIB for m in mods)
            for m in mods:
                m.LIB.lib()
        split["libraries_s"] = time.perf_counter() - t

        t = time.perf_counter()
        server.compiled_for(in_shape, nb)
        built = time.perf_counter() - t
        comp = next(s for s in spans if s["name"] == "compile")
        split["weights_s"] = comp["t0"] - t
        split["pack_s"] = comp["dur_s"]
        split["capture_s"] = built - split["weights_s"] - split["pack_s"]
        setup_stats = server.stats()
        obs_trace.configure(None, enabled=False)

        if entry not in ("infer", "infer_batch", "submit"):
            raise ValueError(f"unknown traffic entry {entry!r}")
        keep = lambda j: load.sampled(pseed, j, tr["check_every"])

        t = time.perf_counter()
        stream = load.Stream(pseed, in_shape)
        # what set-up made lives on: no collection walks it in the window
        gc.collect()
        gc.freeze()
        if entry == "submit":
            sched = ContinuousScheduler(server,
                                        batch_window_s=tr["batch_window_s"])
            clients = load.SubmitClients(tr["clients"], stream, sched.submit,
                                         keep)
        else:
            send = (lambda xs: [server.infer(xs[0])]) if entry == "infer" \
                else server.infer_batch
            clients = load.Clients(tr["clients"], k, stream, send, keep)
        while clients.count() < tr["warmup_requests"]:
            time.sleep(0.005)
        prof = None
        window_spans: List[Dict] = []
        if trace:
            obs_trace.configure(window_spans, enabled=True)
            if dev.type == "cuda":
                from devtrace import Profiler
                prof = Profiler()
                prof.start()
        t0 = time.perf_counter()
        split["warmup_s"] = t0 - t
        setup_s = t0 - t_start
        devwin = None
        if prof is not None:
            time.sleep(max(0.0, t0 + min(seconds, PROFILE_S)
                           - time.perf_counter()))
            # the profiler stops on a quiet card: stopping it under
            # live CUDA work from the clients' threads can hang
            tp = time.perf_counter()
            clients.pause(GRACE_S)
            devwin = prof.stop(window_spans, tp)
            clients.resume()
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        t1 = time.perf_counter()
        hung = clients.stop(GRACE_S)
        obs_trace.configure(None, enabled=False)
        mem_peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        errors = list(clients.errors)
        due = clients.started_in(t0, t1)
        # the per-layer metrics read the traced window, which ends before
        # the profiler's reduction holds up the clients
        tm = devwin.t1 if devwin is not None else t1
        done = [r for r in clients.in_window(t0, tm) if r.ok]
        kernel_launches = sum(expected_launches(sel).values())
        by_name = {l.name: l for l in layers}
        kernel_bound = sum(
            work.bound_s(by_name[nid], nb, peak) for nid, c in
            sel.choices.items()
            if peak and c.primitive is not None
            and c.primitive.name.split("@")[0] in LAUNCH_COUNTER_OF)
    finally:
        if clients is not None:
            clients.stop(GRACE_S)
        if sched is not None:
            sched.close()
        server.close()
        obs_trace.configure(None, enabled=False)
        gc.unfreeze()
    del server, sched, clients
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check: every sampled answer due in the window ----
    kept: Dict[int, Dict[str, np.ndarray]] = {}
    for r in due:
        kept.update(r.kept)
    failed = sum(not r.ok for r in due) + hung
    checks, ctl = check(spec, in_shape, stream, kept, dev, control)
    checks["failed_requests"] = {"value": failed, "limit": 0}
    correct = bool(kept) and all(c["value"] <= c["limit"]
                                 for c in checks.values())

    ctx = SimpleNamespace(
        window_s=tm - t0, done=done, images=sum(r.images for r in done),
        setup_s=setup_s, setup_stats=setup_stats,
        spans=[sp for sp in window_spans if sp["t0"] + sp["dur_s"] <= tm]
        if trace else None,
        device=devwin, layers=layers, peak=peak,
        kernel_launches_per_forward=kernel_launches,
        kernel_bound_s=kernel_bound)
    metrics = {}
    for m in spec.metrics:
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": torch.cuda.get_device_name(dev)
               if dev.type == "cuda" else "cpu",
               "count": 1, "memory_peak_bytes": int(mem_peak)}
    out = {"correct": correct, "attempted": len(due) + hung,
           "failed": failed, "metrics": metrics, "device": devinfo}
    if devwin is not None:
        devinfo["busy_s"] = devwin.busy_s
        devinfo["window_s"] = devwin.window_s
        out["breakdown"] = {"device_ops": devwin.top_ops(),
                            "idle_gaps": devwin.top_idle()}
    out["setup"] = split
    out["compared_images"] = len(kept)
    if ctl is not None:
        out["control_logit_rel_err"] = ctl
    if errors:
        out["errors"] = [e[-2000:] for e in errors]
    out["checks"] = checks
    return out


def check(spec: Spec, in_shape, stream: "load.Stream",
          kept: Dict[int, Dict[str, np.ndarray]], dev,
          control: bool) -> Tuple[Dict[str, Dict], Optional[float]]:
    """Each compared number beside its limit, and the control's reading
    of the first (None unless ``control``).  The reference draws the
    weights and the sampled images again from the seed and runs them in
    float32 with TF32 off; the control is the same reference in TF32, put
    in the program's place."""
    cfg = spec.config
    ref = importlib.import_module(f"reference.{cfg['reference']}")
    out_name = cfg["layers"][-1]["name"]
    idx = sorted(kept)
    lim = spec.checks["logit_rel_err"]["limit"]
    if not idx:
        return {"logit_rel_err": {"value": float("inf"), "limit": lim}}, None
    for j in idx:
        if set(kept[j]) != {out_name}:
            raise RuntimeError(f"the server returned {sorted(kept[j])}; "
                               f"the reference computes {out_name!r}")
    images = np.stack([load.image(stream.px, stream.seed, j, in_shape)
                       for j in idx])
    params = ref.to_device(ref.init_params(cfg["layers"], in_shape,
                                           stream.seed), dev)
    block = spec.checks["block"]
    want = ref.run(cfg["layers"], params, images, dev, block=block)
    got = np.stack([kept[j][out_name].reshape(-1) for j in idx])
    checks = {"logit_rel_err": {"value": ref.max_logit_err(got, want),
                                "limit": lim}}
    ctl = None
    if control:
        ctl = ref.max_logit_err(ref.run(cfg["layers"], params, images, dev,
                                        block=block, prec="tf32"), want)
    return checks, ctl
