"""The port's conv ``PlanServer`` against the reference's, on the CPU.

Both servers take one mixed request stream (``infer``, ``infer_batch``
and ``enqueue`` + ``flush``), drawn from a numpy seed, over
``conv_tower`` and ``conv_stack``; the port's with ``device="cpu"``,
where ``jit`` has no effect and its primitives run their plain PyTorch
versions.  Compared after the stream:

* every answer, per request and output node, within ``REL_TOL`` of the
  reference's largest magnitude: both packages sum in f32, in other
  orders (a few hundred terms per output at these widths, so errors of
  a few f32 ulps of the largest term; 1e-4 leaves a margin);
* the selection of every bucket (primitive names, layouts, conversion
  chains and fused edges), which must be identical: the port's
  selection modules are the reference's, byte for byte;
* the serving counters, which must be equal.

One case prices the kernels (the TPU spec with the kernel primitives),
so that a Pallas primitive is served: the reference runs it in interpret
mode, as its own tests do, the port its plain version.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import costs as RC
from repro.serving import BucketPolicy as RPolicy
from repro.serving import PlanServer as RServer
from repro.serving import conv_stack as r_stack
from repro.serving import conv_tower as r_tower
from repro_torch.core import costs as TC
from repro_torch.serving import BucketPolicy as TPolicy
from repro_torch.serving import PlanServer as TServer
from repro_torch.serving import conv_stack as t_stack
from repro_torch.serving import conv_tower as t_tower

REL_TOL = 1e-4
#: the counters held equal: everything but wall times
COUNTERS = ("requests", "plan_mem_hits", "plan_disk_hits", "plan_misses",
            "exec_hits", "exec_misses", "exec_evictions", "batch_calls",
            "coalesced", "solves", "warm_solves", "compiles",
            "mesh_compiles", "plan_cache_corrupt", "ladder_exact",
            "ladder_anytime", "ladder_greedy", "ladder_reference",
            "compile_retries", "compile_fallbacks", "kernel_failures",
            "quarantines")
POLICY = dict(min_hw=8, max_hw=64, max_n=4)
BUILDERS = {"tower": (r_tower, t_tower, dict(depth=2, width=4)),
            "stack": (r_stack, t_stack, dict(depth=2, width=4)),
            # wide enough that the kernel-priced TPU spec serves
            # pallas_direct_hwc on conv1
            "stack64": (r_stack, t_stack, dict(depth=2, width=64))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _costs(kernels: bool):
    if kernels:
        return (RC.AnalyticCostModel(RC.TPU_V5E_SPEC, include_tpu_only=True),
                TC.AnalyticCostModel(
                    TC.HardwareSpec(**dataclasses.asdict(RC.TPU_V5E_SPEC)),
                    include_kernels=True))
    return RC.AnalyticCostModel(), TC.AnalyticCostModel()


def servers(builder="tower", kernels=False, **kw):
    """The reference's server and the port's, configured alike."""
    rb, tb, bkw = BUILDERS[builder]
    rc, tc = _costs(kernels)
    kw.setdefault("lru_capacity", 8)
    kw.setdefault("compile_backoff_s", 0.001)
    ref = RServer(lambda s: rb(s, **bkw), rc, policy=RPolicy(**POLICY),
                  **kw)
    port = TServer(lambda s: tb(s, **bkw), tc, policy=TPolicy(**POLICY),
                   device="cpu", **kw)
    return ref, port


def stream(seed, n_ops, channels, hw=(8, 40),
           kinds=("infer", "batch", "queue")):
    """A mixed request stream: ("infer", x), ("batch", xs) or ("queue",
    xs), with shapes and values from ``seed``."""
    rng = np.random.default_rng(seed)

    def img():
        c = int(rng.choice(channels))
        h, w = (int(v) for v in rng.integers(hw[0], hw[1] + 1, size=2))
        return rng.normal(size=(c, h, w)).astype(np.float32)

    ops = []
    for _ in range(n_ops):
        kind = str(rng.choice(kinds))
        ops.append((kind, img() if kind == "infer" else
                    [img() for _ in range(int(rng.integers(1, 6)))]))
    return ops


def drive(srv, ops):
    """Every answer of the stream, one dict per request, in order."""
    outs = []
    for kind, xs in ops:
        if kind == "infer":
            outs.append(srv.infer(xs))
        elif kind == "batch":
            outs.extend(srv.infer_batch(xs))
        else:
            futs = [srv.enqueue(x) for x in xs]
            assert srv.flush() == len(xs)
            outs.extend(f.result(timeout=60) for f in futs)
    return outs


def selections(srv):
    """Each solved bucket's plan as names and layouts."""
    return {pkey: (sorted((nid, c.primitive.name if c.primitive else None,
                           c.l_in, c.l_out)
                          for nid, c in sel.choices.items()),
                   sorted(sel.conversions.items()),
                   sorted(sel.fusions.items()), sel.strategy)
            for pkey, sel in srv._plans.items()}


def counters(srv):
    s = srv.stats()
    return {k: s[k] for k in COUNTERS}


def assert_answers_agree(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for nid in w:
            a, b = np.asarray(g[nid]), np.asarray(w[nid])
            assert a.shape == b.shape and a.dtype == b.dtype
            assert np.isfinite(a).all()
            err = float(np.abs(a - b).max())
            assert err <= REL_TOL * max(float(np.abs(b).max()), 1e-30), \
                (nid, err)


def assert_same_serving(ref, port, want, got):
    assert_answers_agree(got, want)
    assert selections(port) == selections(ref)
    assert counters(port) == counters(ref)


# (builder, kernels priced, server options, channels, stream seed, ops).
# The eviction case sends single requests only: a batch spanning several
# buckets builds them on the worker pool at once, so which executable an
# LRU of two evicts depends on the threads' timing, in either package.
CASES = {
    "tower": ("tower", False, {}, (3,), 0, 8),
    "tower_lru_evicts": ("tower", False, dict(lru_capacity=2), (3, 4), 1, 12),
    "stack": ("stack", False, {}, (3, 8), 2, 8),
    "stack_fused": ("stack", False, dict(fuse=True), (3, 8), 3, 6),
    "stack_greedy": ("stack", False, dict(exact=False), (3,), 4, 5),
    "stack_kernels": ("stack64", True, {}, (32,), 5, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_one_stream_same_answers_plans_and_counters(case):
    builder, kernels, kw, channels, seed, n_ops = CASES[case]
    ref, port = servers(builder, kernels, **kw)
    ops = stream(seed, n_ops, channels,
                 hw=(24, 32) if builder == "stack64" else (8, 40),
                 kinds=("infer",) if case == "tower_lru_evicts" else
                 ("infer", "batch", "queue"))
    try:
        want, got = drive(ref, ops), drive(port, ops)
        assert_same_serving(ref, port, want, got)
        if case == "stack_kernels":
            served = {c.primitive.name for sel in port._plans.values()
                      for c in sel.choices.values() if c.primitive}
            assert "pallas_direct_hwc" in served
        if case == "tower_lru_evicts":
            assert counters(port)["exec_evictions"] > 0
    finally:
        ref.close()
        port.close()


def test_prefetch_then_serve_counts_alike():
    ref, port = servers("tower")
    x = np.random.default_rng(7).normal(size=(3, 20, 20)).astype(np.float32)
    try:
        for srv in (ref, port):
            srv.prefetch((3, 20, 20)).result(timeout=120)
            srv.prefetch((3, 20, 20), n=2).result(timeout=120)
        assert_same_serving(ref, port, [ref.infer(x)] + ref.infer_batch(
            [x, x]), [port.infer(x)] + port.infer_batch([x, x]))
        assert counters(port)["compiles"] == 2
    finally:
        ref.close()
        port.close()


def test_a_shared_cache_dir_is_not_read_across_packages(tmp_path):
    """Each package's second server reads its own plan from disk and
    never the other's: the port folds ``+torch`` into the cost version
    every cache tier keys on."""
    x = np.random.default_rng(8).normal(size=(3, 16, 16)).astype(np.float32)
    ref, port = servers("tower", cache_dir=tmp_path)
    ref.infer(x)
    ref.close()
    port.infer(x)
    s = port.stats()
    assert (s["solves"], s["plan_disk_hits"]) == (1, 0)
    assert port.cost_version.endswith("+torch")
    port.close()
    assert len(list(tmp_path.glob("*.json"))) == 2
    for srv in servers("tower", cache_dir=tmp_path):
        srv.infer(x)
        s = srv.stats()
        assert (s["solves"], s["plan_disk_hits"]) == (0, 1)
        srv.close()


def test_mesh_serving_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="slice G"):
        TServer(lambda s: t_tower(s), TC.AnalyticCostModel(), mesh=object(),
                device="cpu")
