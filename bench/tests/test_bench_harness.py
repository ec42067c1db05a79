"""The harness on the CPU: its files, its runs at reduced networks, its
reference and its check.  What needs the card is in
``test_bench_control.py``."""
import ast
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
#: each configuration's file by its name; its ``cpu_scale`` is the
#: smallest scale whose every layer keeps a pixel
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in SPEC["configs"]}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def metrics_of(cell, kind):
    return [m["name"] for m in SPEC[kind]
            if cell in m.get("workloads", CELLS)]


def scale_of(cell):
    return CONFIGS[next(w["config"] for w in SPEC["workloads"]
                        if w["name"] == cell)]["cpu_scale"]


def test_every_named_file_is_there():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and 0 < cfg["cpu_scale"] <= 1
        assert (BENCH / "reference" / f"{cfg['reference']}.py").is_file()
    for w in SPEC["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        checks = json.loads((BENCH / "checks" / f"{w['name']}.json")
                            .read_text())
        assert checks["logit_rel_err"]["limit"] > 0
    import cell
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(cell.reader(m["name"]))


def test_the_file_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        e2e_here = metrics_of(w["name"], "end_to_end")
        assert "setup_s" in e2e_here and len(e2e_here) >= 2
        assert metrics_of(w["name"], "per_layer")
        for m in SPEC["per_layer"]:
            if w["name"] in m.get("workloads", CELLS):
                assert m["moves"] in e2e_here, (w["name"], m["name"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def cpu_run(cell_name, seconds=3.0, seed=4_000_000_123):
    """One run on the CPU in a fresh process: its result and the
    forbidden top-level modules it loaded."""
    code = (
        "import sys, time, json\n"
        "t = time.perf_counter()\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(BENCH)!r}]\n"
        "import cell, load, run\n"
        # every image checked: a short window on the CPU makes few
        "load.sampled = lambda seed, j, every: True\n"
        f"out = cell.run({cell_name!r}, {seed}, {seconds}, False, "
        f"t_start=t, device='cpu', scale={scale_of(cell_name)})\n"
        "print(json.dumps({'out': out, 'forbidden': run.forbidden_modules()}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_cpu_run_is_correct_and_loads_no_jax(cell_name):
    got = cpu_run(cell_name)
    out = got["out"]
    assert got["forbidden"] == []
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["compared_images"] > 0
    assert set(out["metrics"]) == set(metrics_of(cell_name, "end_to_end"))
    assert list(out)[-1] == "checks"


def test_the_scheduler_traffic_runs_correct(monkeypatch):
    """``clients64`` (kept for a later cell): 64 closed-loop clients
    through the continuous scheduler, driven by one thread."""
    sys.path.insert(0, str(ROOT / "src"))
    import cell
    import load
    spec = cell.load_spec("alexnet.b1", False)
    spec.traffic = json.loads((BENCH / "traffic" / "clients64.json")
                              .read_text())
    monkeypatch.setattr(cell, "load_spec", lambda w, trace: spec)
    monkeypatch.setattr(load, "sampled", lambda seed, j, every: True)
    out = cell.run("alexnet.b1", 4_000_000_777, 2.0, False,
                   t_start=time.perf_counter(), device="cpu",
                   scale=CONFIGS["alexnet"]["cpu_scale"])
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 64 and out["compared_images"] > 0


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("repro_torch", "repro", "jax",
                                               "jaxlib", "flax"), (path, m)
    code = (f"import sys; sys.path.insert(0, {str(BENCH)!r})\n"
            "import reference.sequential\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    mods = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, check=True).stdout
    assert "repro_torch" not in mods and "'repro'" not in mods


def assert_draws_the_programs_weights(cfg, scale):
    sys.path.insert(0, str(ROOT / "src"))
    from reference import sequential
    from repro_torch.convnets import NETWORKS
    net = NETWORKS[cfg["network"]](scale)
    shape = net.nodes[net.order[0]].out_shape
    theirs = net.init_params(2 ** 31 + 7)
    mine = sequential.init_params(cfg["layers"], shape, 2 ** 31 + 7)
    named = {s["name"]: p for s, p in zip(cfg["layers"], mine) if p}
    assert set(named) == set(theirs)
    for nid, p in theirs.items():
        for k, v in p.items():
            assert np.array_equal(named[nid][k], v), (nid, k)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_the_reference_draws_the_programs_weights(cfg_name):
    """The reference's frozen He initialisation gives the program's
    weights bit for bit, without reading them."""
    cfg = CONFIGS[cfg_name]
    assert_draws_the_programs_weights(cfg, cfg["cpu_scale"])


def test_the_image_stream_is_the_seeds():
    import load
    seed = 2 ** 40 + 1
    s = load.Stream(seed, (3, 8, 8))
    (j0, a), (j1, b) = s.take(2)
    assert (j0, j1) == (0, 1) and s.take(1)[0][0] == 2
    assert np.array_equal(a, load.image(load.pool(seed), seed, 0, (3, 8, 8)))
    assert not np.array_equal(a, b)
    assert not np.array_equal(s.px[:64], load.pool(seed + 1)[:64])
    assert a.dtype == np.float32 and abs(float(s.px.mean())) < 0.01


def test_the_check_samples_every_row_of_a_batch():
    import load
    rows = [j % 32 for j in range(32 * 400) if load.sampled(2 ** 33 + 5, j, 128)]
    assert 60 < len(rows) < 140
    assert len(set(rows)) > 24


def fake_submit(pool):
    def submit(x):
        return pool.submit(lambda: (time.sleep(0.002), {"prob": x[:1]})[1])
    return submit


@pytest.mark.parametrize("kind", ["threads", "one sender"])
def test_paused_clients_send_nothing_until_resumed(kind):
    """The traced run pauses the load before it stops the profiler: no
    request is in flight or sent while paused."""
    from concurrent.futures import ThreadPoolExecutor
    import load
    stream = load.Stream(7, (3, 4, 4))
    pool = ThreadPoolExecutor(4)
    keep = lambda j: j % 3 == 0
    if kind == "threads":
        send = lambda xs: [{"prob": x[:1]} for x in xs if time.sleep(0.002)
                           is None]
        clients = load.Clients(3, 2, stream, send, keep)
    else:
        clients = load.SubmitClients(8, stream, fake_submit(pool), keep)
    try:
        time.sleep(0.1)
        clients.pause(5.0)
        n = clients.count()
        t = time.perf_counter()
        time.sleep(0.1)
        assert clients.count() == n
        assert not clients.started_in(t, time.perf_counter())
        clients.resume()
        time.sleep(0.1)
        assert clients.count() > n
    finally:
        assert clients.stop(5.0) == 0
        pool.shutdown()
    assert all(r.ok for r in clients.requests)
    assert any(r.kept for r in clients.requests)


def roll_classes(out):
    """An answer altered where it is produced: each image gets the next
    class's probabilities."""
    return {k: v.roll(1, dims=-3) for k, v in out.items()}


def half_batch(out):
    """Half of the batch left out: its rows carry the other half's
    answers."""
    res = {}
    for k, v in out.items():
        v = v.clone()
        h = v.shape[0] // 2
        v[h:2 * h] = v[:h]
        res[k] = v
    return res


FAULTS = [(c, f) for c in CELLS for f in (roll_classes, half_batch)
          if f is roll_classes or not c.endswith(".b1")]


@pytest.mark.parametrize("cell_name, fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell_name, fault, monkeypatch):
    """The harness's run past its look for a card, with the executable
    that the window drives broken underneath: ``correct`` is false."""
    sys.path.insert(0, str(ROOT / "src"))
    import cell
    import load
    from repro_torch.core.plan import CompiledNet
    monkeypatch.setattr(load, "sampled", lambda seed, j, every: True)
    call = CompiledNet.__call__
    monkeypatch.setattr(CompiledNet, "__call__",
                        lambda self, x: fault(call(self, x)))
    out = cell.run(cell_name, 4_000_000_321, 3.0, False,
                   t_start=time.perf_counter(), device="cpu",
                   scale=scale_of(cell_name))
    assert out["compared_images"] > 0
    assert out["correct"] is False
    c = out["checks"]["logit_rel_err"]
    assert c["value"] > c["limit"]


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    if proc.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert proc.returncode == 2 and proc.stdout == ""
