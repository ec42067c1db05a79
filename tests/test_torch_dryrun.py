"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

Each run is a process of its own: the dry-run makes the default process
group a ``"fake"`` one of 256 or 512 ranks (no device, no storage), which
must not outlive it.

* A scaled cell on a 2 x 2 fake mesh with Megatron rules: its all-reduce
  count and bytes are the hand count, 2 per layer in a forward pass
  (attention's and the FFN's row-parallel outputs) and 1 for the
  vocab-parallel embedding's partial sums, each of the activation slab
  ``b_local x t x d_model`` in bf16.
* The CLI on a full cell, ``tinyllama-1.1b`` at ``decode_32k``, exits 0
  with 256 ranks (512 with ``--multi-pod``) and a non-empty collectives
  table; its ``params_total``, ``params_active``, ``model_flops`` and
  ``sharding_report`` equal the reference's pure functions
  (``param_count``, ``active_param_count``, the model-flops formula,
  ``select_rules`` on the same H100 figures).
* ``run_all`` writes a marker artifact for a skipped cell and runs none
  whose artifact is already ``ok``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro import models as R
from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as r_config
from repro.core import costs as RC
from repro.core.sharding_select import select_rules as r_select
from repro_torch.core import costs as TC

import _torch_mesh_lm_cases as C

R_H100 = RC.HardwareSpec(**dataclasses.asdict(TC.H100_SPEC))
SMALL = C.SMALL


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(C.REPO / "src"),
                                         str(C.REPO / "tests")])
    return env


def _python(code, timeout=300):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def scaled():
    """The scaled cell's prefill and decode records on 2 x 2."""
    return _python(f"""
import dataclasses, json
from repro_torch.configs import SHAPES
from repro_torch.launch.dryrun import run_cell
out = {{}}
for kind in ("prefill", "decode"):
    shp = dataclasses.replace(SHAPES["train_4k"], name=kind, seq_len=32,
                              global_batch=8, kind=kind)
    out[kind] = run_cell("tinyllama-1.1b", kind, multi_pod=False,
                         rules_mode="megatron",
                         mesh_shape={{"data": 2, "model": 2}},
                         scale={SMALL!r}, shape=shp)
print(json.dumps(out))
""")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_scaled_cell_all_reduce_hand_count(scaled, kind):
    rec = scaled[kind]
    assert rec["status"] == "ok" and rec["n_devices"] == 4
    b_local, t, d = 8 // 2, 32 if kind == "prefill" else 1, SMALL["d_model"]
    ar = rec["collectives"]["all-reduce"]
    n = 2 * SMALL["n_layers"] + 1
    assert ar["count"] == n, ar
    assert ar["bytes"] == n * b_local * t * d * 2, ar
    assert rec["flops_per_device"] > 0


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    out = {}
    for mp in (False, True):
        d = tmp_path_factory.mktemp("dryrun")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               "tinyllama-1.1b", "--shape", "decode_32k", "--out", str(d)]
        proc = subprocess.run(cmd + (["--multi-pod"] if mp else []),
                              capture_output=True, text=True, timeout=300,
                              env=_env())
        out[mp] = (proc, d)
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cli_full_cell(cli, multi_pod):
    proc, d = cli[multi_pod]
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout)
    tag = "2x16x16" if multi_pod else "16x16"
    assert rec["status"] == "ok" and rec["mesh"] == tag
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert any(v["count"] for v in rec["collectives"].values())
    assert rec["collective_bytes_per_device"] > 0
    saved = json.loads((d / f"tinyllama-1.1b__decode_32k__{tag}.json")
                       .read_text())
    assert saved["collectives"] == rec["collectives"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cli_pure_fields_match_reference(cli, multi_pod):
    rec = json.loads(cli[multi_pod][0].stdout)
    cfg, shape = r_config("tinyllama-1.1b"), R_SHAPES["decode_32k"]
    assert rec["params_total"] == R.param_count(cfg)
    assert rec["params_active"] == R.active_param_count(cfg)
    assert rec["model_flops"] == 2 * R.active_param_count(cfg) * \
        shape.global_batch
    mesh = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    _, want = r_select(cfg, shape, mesh, spec=R_H100)
    assert rec["sharding_report"] == json.loads(json.dumps(want))


def test_a_failing_cell_writes_an_error_artifact(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "decode_32k", "--out", str(tmp_path),
         "--variant", "no_such_knob=1"], capture_output=True, text=True,
        timeout=300, env=_env())
    assert proc.returncode == 1
    rec = json.loads((tmp_path / "tinyllama-1.1b__decode_32k__16x16.json")
                     .read_text())
    assert rec["status"] == "error" and "no_such_knob" in rec["error"]


def test_run_all_skips_and_resumes(tmp_path):
    """Every cell already ``ok`` is not run again; a skipped cell gets
    its marker."""
    from repro_torch.configs import cells
    from repro_torch.launch.dryrun import cell_name
    for arch, shape, skip in cells():
        if not skip:
            for mp in (False, True):
                (tmp_path / f"{cell_name(arch, shape, mp)}.json").write_text(
                    json.dumps({"status": "ok"}))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.run_all", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        env=_env())
    assert proc.returncode == 0, proc.stderr
    assert "0 cells to run" in proc.stdout
    skipped = [a for a, s, k in cells() if k]
    assert skipped
    rec = json.loads((tmp_path / f"{cell_name(skipped[0], 'long_500k', False)}"
                      ".json").read_text())
    assert rec["status"] == "skipped"
