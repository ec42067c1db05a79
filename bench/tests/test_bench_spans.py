"""The reader of the program's host-step spans in a traced run on the
CPU: ``copy_in_ms`` finds its spans, inside ``execute``'s."""
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))


def test_a_traced_cpu_run_reads_the_host_steps(monkeypatch):
    sys.path.insert(0, str(BENCH.parent / "src"))
    import cell
    import load
    monkeypatch.setattr(load, "sampled", lambda seed, j, every: True)
    # AlexNet at 0.3 of its widths: the smallest scale whose every layer
    # keeps a pixel
    out = cell.run("alexnet.b1", 4_000_000_321, 3.0, True,
                   t_start=time.perf_counter(), device="cpu", scale=0.3)
    assert out["correct"] is True, out["checks"]
    m = out["metrics"]
    assert 0 < m["copy_in_ms"]["value"] < m["execute_ms"]["value"]
