"""The port's host-step spans (``repro_torch.obs.spans``) on the CPU.

A small ``PlanServer`` traced into a list: ``infer`` and ``infer_batch``
give their span trees (one trace per call, each child inside its
parent's interval), with tracing off nothing is recorded and no span is
opened, and while ``torch.profiler`` records each span is also a
profiler range of its name.  The benchmark's reader of the spans is
held to hand-built span lists.  What needs the card (the graph's
``replay`` and ``device_wait``) is in ``test_torch_card.py``.
"""
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from repro_torch.core.costs import AnalyticCostModel
from repro_torch.obs import span, spans, tracing
from repro_torch.obs.trace import NULL_SPAN, configure
from repro_torch.serving import BucketPolicy, PlanServer, conv_stack

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (3, 20, 20)
#: the spans under ``execute`` on the CPU's eager walk: no graph to
#: replay, no stream to wait on
EAGER_STEPS = ["copy_in", "copy_out", "guard"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _server(guard_outputs=True):
    """A conv stack served on the CPU, its buckets warm: the executables
    for one image and for batches of two and one."""
    srv = PlanServer(lambda s: conv_stack(s, depth=2, width=8),
                     AnalyticCostModel(), policy=BucketPolicy(
                         min_hw=8, max_hw=64, max_n=2), device="cpu",
                     guard_outputs=guard_outputs)
    x = _images(1)[0]
    srv.infer(x)
    srv.infer_batch([x, x, x])
    return srv


@pytest.fixture
def server():
    srv = _server()
    yield srv
    srv.close()


@pytest.fixture
def records():
    recs = []
    configure(recs, enabled=True)
    try:
        yield recs
    finally:
        configure(None, enabled=False)


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=SHAPE).astype(np.float32) for _ in range(n)]


def _children(recs, parent):
    return [r["name"] for r in sorted(recs, key=lambda r: r["t0"])
            if r["parent"] == parent["span"]]


def _assert_well_formed(recs):
    """One trace per root; every child inside its parent's interval, of
    its parent's trace."""
    by_id = {r["span"]: r for r in recs}
    assert len(by_id) == len(recs)
    for r in recs:
        assert r["dur_s"] >= 0, r
        if r["parent"] is None:
            assert r["trace"] == r["span"]
            continue
        p = by_id[r["parent"]]
        assert r["trace"] == p["trace"]
        assert p["t0"] <= r["t0"]
        assert r["t0"] + r["dur_s"] <= p["t0"] + p["dur_s"] + 1e-9


def test_infer_gives_its_span_tree(server, records):
    server.infer(_images(1)[0])
    _assert_well_formed(records)
    (root,) = [r for r in records if r["parent"] is None]
    assert root["name"] == "infer" and root["shape"] == "3x20x20"
    assert _children(records, root) == ["lookup", "pad", "execute", "crop"]
    ex = next(r for r in records if r["name"] == "execute")
    assert ex["bucket"] == "c4h32w32"
    assert _children(records, ex) == EAGER_STEPS
    assert {r["trace"] for r in records} == {root["span"]}


def test_infer_batch_gives_its_span_tree(server, records):
    """Three images at ``max_n = 2``: two chunks, each looked up, stacked,
    executed and cropped beside the other, under one trace."""
    server.infer_batch(_images(3))
    _assert_well_formed(records)
    (root,) = [r for r in records if r["parent"] is None]
    assert root["name"] == "infer_batch"
    assert root["requests"] == 3 and root["invocations"] == 2
    assert _children(records, root) == \
        ["lookup", "stack", "execute", "crop"] * 2
    for ex in (r for r in records if r["name"] == "execute"):
        assert _children(records, ex) == EAGER_STEPS
    assert {r["trace"] for r in records} == {root["span"]}


def test_an_unguarded_server_has_no_guard_span(records):
    srv = _server(guard_outputs=False)
    try:
        records.clear()
        srv.infer(_images(1)[0])
    finally:
        srv.close()
    ex = next(r for r in records if r["name"] == "execute")
    assert _children(records, ex) == ["copy_in", "copy_out"]


def test_one_trace_per_call(server, records):
    x = _images(1)[0]
    server.infer(x)
    server.infer_batch([x, x])
    server.infer(x)
    roots = [r for r in records if r["parent"] is None]
    assert [r["name"] for r in roots] == ["infer", "infer_batch", "infer"]
    assert len({r["trace"] for r in records}) == 3
    _assert_well_formed(records)


def test_tracing_off_records_nothing_and_opens_no_span(server,
                                                        monkeypatch):
    recs = []
    configure(recs, enabled=False)

    def opened(*args, **kwargs):
        raise AssertionError("a span opened with tracing off")

    monkeypatch.setattr(spans, "_Step", opened)
    monkeypatch.setattr(spans, "_profiler_range", opened)
    try:
        x = _images(1)[0]
        server.infer(x)
        server.infer_batch([x, x, x])
    finally:
        configure(None, enabled=False)
    assert recs == []


def test_the_off_path_is_one_shared_context():
    assert not tracing()
    off = span("infer")
    assert span("copy_in", bucket="b") is off
    with off as sp:
        assert sp is NULL_SPAN


def test_a_span_that_raises_is_written_and_raises(records):
    with pytest.raises(KeyError):
        with span("execute", bucket="b"):
            with span("copy_in"):
                raise KeyError("launch")
    assert [r["name"] for r in records] == ["copy_in", "execute"]
    _assert_well_formed(records)
    assert records[1]["bucket"] == "b"


def test_spans_are_profiler_ranges_of_their_names(server, records):
    from torch.profiler import ProfilerActivity, profile
    x = _images(1)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        server.infer(x)
        server.infer_batch([x, x])
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"infer", "infer_batch", "lookup", "pad", "stack", "execute",
            "copy_in", "copy_out", "guard", "crop"} <= names
    # the ranges are ranges of the records written
    assert {r["name"] for r in records} <= names


def test_the_profilers_private_names_are_there():
    """The range rests on two private names of ``torch``; an upgrade that
    drops either turns the ranges off (below), and fails here."""
    assert callable(torch._C._autograd._profiler_enabled)
    assert callable(torch._C._profiler._RecordFunctionFast)


@pytest.mark.parametrize("missing", [
    ("_autograd", "_profiler_enabled"),
    ("_profiler", "_RecordFunctionFast"),
])
def test_a_torch_without_the_names_opens_no_range(records, monkeypatch,
                                                  missing):
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.delattr(getattr(torch._C, missing[0]), missing[1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("copy_in"):
            pass
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "copy_in" not in names
    assert [r["name"] for r in records] == ["copy_in"]


def test_no_range_without_a_profiler(records):
    assert spans._profiler_range("copy_in") is None
    with span("copy_in"):
        pass
    assert [r["name"] for r in records] == ["copy_in"]


def _reader(name):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _rec(name, trace, span_id, parent, dur_s, **attrs):
    return {"name": name, "trace": trace, "span": span_id, "parent": parent,
            "t0": 0.0, "dur_s": dur_s, **attrs}


#: two calls: an ``infer`` (trace 1) and an ``infer_batch`` (trace 10),
#: and a ``copy_in`` of a warm-up outside both (trace 20)
SPANS = [
    _rec("lookup", 1, 2, 1, 0.010),
    _rec("pad", 1, 3, 1, 0.004),
    _rec("copy_in", 1, 5, 4, 0.030),
    _rec("replay", 1, 6, 4, 0.002),
    _rec("device_wait", 1, 7, 4, 0.400),
    _rec("copy_out", 1, 8, 4, 0.006),
    _rec("guard", 1, 9, 4, 0.001),
    _rec("execute", 1, 4, 1, 0.450, bucket="b"),
    _rec("crop", 1, 10, 1, 0.002),
    _rec("infer", 1, 1, None, 0.470, shape="3x8x8"),
    _rec("lookup", 11, 12, 11, 0.001),
    _rec("stack", 11, 13, 11, 0.020),
    _rec("copy_in", 11, 15, 14, 0.050),
    _rec("replay", 11, 16, 14, 0.003),
    _rec("copy_out", 11, 17, 14, 0.010),
    _rec("execute", 11, 14, 11, 0.600, bucket="b"),
    _rec("crop", 11, 18, 11, 0.005),
    _rec("infer_batch", 11, 11, None, 0.650, requests=2),
    _rec("copy_in", 20, 20, None, 0.090),
]


def _ctx(spans):
    return types.SimpleNamespace(spans=spans)


def test_copy_in_ms_is_the_mean_copy_in():
    # (30 + 50 + 90) ms over three copy_in spans
    assert _reader("copy_in_ms")(_ctx(SPANS)) == pytest.approx(170 / 3)


@pytest.mark.parametrize("what", ["no window", "no spans", "older program"])
def test_copy_in_ms_finds_nothing_to_read(what):
    """No window, no spans, or the spans of a program without ``copy_in``:
    None, never a raise."""
    older = [r for r in SPANS
             if r["name"] in ("infer", "infer_batch", "execute", "crop")]
    ctx = {"no window": _ctx(None), "no spans": _ctx([]),
           "older program": _ctx(older)}[what]
    assert _reader("copy_in_ms")(ctx) is None
