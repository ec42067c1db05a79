"""The PyTorch port stands alone: it imports nothing of JAX or of the
reference package, its verbatim copies stay verbatim, and its entry
points refuse to run on the CPU unasked."""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

#: modules the port keeps as byte-identical copies of the reference's
VERBATIM = ["core/scenario.py", "core/layouts.py",
            "core/winograd_transforms.py", "core/ioutil.py", "core/pbqp.py",
            "core/choice_space.py", "core/selection.py", "obs/trace.py",
            "obs/metrics.py", "convnets/alexnet.py", "convnets/vgg.py",
            "convnets/googlenet.py", "convnets/__init__.py",
            "serving/bucketing.py"]

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
from repro_torch.core.primitives import registry
registry()
print(json.dumps({"modules": names,
                  "jax": sorted(m for m in sys.modules
                                if m == "jax" or m.startswith("jax.")),
                  "repro": sorted(m for m in sys.modules
                                  if m == "repro" or m.startswith("repro."))}))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    PyTorch's default of one thread per core would oversubscribe the
    machine under the timing-sensitive tests of the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fresh_import_loads_no_jax_and_no_reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["jax"] == [] and rep["repro"] == []
    expected = {"repro_torch.core.plan", "repro_torch.core.costs",
                "repro_torch.kernels.matmul.ops",
                "repro_torch.kernels.conv_direct.kernel",
                "repro_torch.kernels.winograd_gemm.ops",
                "repro_torch.kernels.conv_im2col.ops",
                "repro_torch.convnets.alexnet", "repro_torch.obs.trace",
                "repro_torch.serving.bucketing", "repro_torch.calibrate.model",
                "repro_torch.calibrate.profile", "repro_torch.calibrate.sweep",
                "repro_torch.launch.calibrate",
                "repro_torch.kernels.layout_transform.kernel",
                "repro_torch.kernels.layout_transform.bench",
                "repro_torch.kernels.flash_attention.kernel",
                "repro_torch.kernels.flash_attention.bench",
                "repro_torch.kernels.matmul.bench",
                "repro_torch.kernels.conv_direct.bench",
                "repro_torch.kernels.conv_im2col.bench",
                "repro_torch.kernels.winograd_gemm.bench"}
    assert expected <= set(rep["modules"])


def test_no_import_statement_names_jax_or_the_reference():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\b"
                     r"|from repro\.)", re.M)
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py"]
    hits = [f"{f}:{m.group(0)}" for f in files
            for m in pat.finditer(f.read_text())]
    assert hits == []


@pytest.mark.parametrize("rel", VERBATIM)
def test_copied_modules_stay_verbatim(rel):
    ref = ROOT / "src" / "repro" / rel
    assert (PORT / rel).read_bytes() == ref.read_bytes()


def test_entry_points_need_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from repro_torch.convnets import alexnet
    from repro_torch.core.costs import AnalyticCostModel, ProfiledCostModel
    from repro_torch.core.plan import compile_plan, params_from_numpy
    from repro_torch.core.selection import select_sum2d
    net = alexnet(0.3)
    sel = select_sum2d(net, AnalyticCostModel())
    params = net.init_params(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_plan(sel, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProfiledCostModel(str(tmp_path / "p.json"))
    cnet = compile_plan(sel, params, device="cpu")
    assert cnet.device.type == "cpu"


def test_mesh_executables_are_not_ported_yet():
    from repro_torch.convnets import alexnet
    from repro_torch.core.costs import AnalyticCostModel
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.selection import select_sum2d
    net = alexnet(0.3)
    sel = select_sum2d(net, AnalyticCostModel())
    with pytest.raises(NotImplementedError, match="slice G"):
        compile_plan(sel, net.init_params(0), batch=2, mesh=object(),
                     device="cpu")
