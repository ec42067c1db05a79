"""The control on the card: the reference in TF32, put in the program's
place at each cell's own size, fails the cell's limit on three seeds,
while the program passes it on the same images.

Marked ``gpu``; run on a machine with an H100 from the checkout's root:
``python -m pytest -m gpu bench/tests``.
"""
import json
import pathlib
import sys
import time

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails_the_limit(card, cell_name):
    import cell
    for seed in (5_000_000_001, 5_000_000_002, 5_000_000_003):
        out = cell.run(cell_name, seed, 2.0, False,
                       t_start=time.perf_counter(), control=True)
        limit = out["checks"]["logit_rel_err"]["limit"]
        assert out["compared_images"] > 0
        assert out["correct"] is True, out["checks"]
        assert out["control_logit_rel_err"] > limit, (seed, out)
