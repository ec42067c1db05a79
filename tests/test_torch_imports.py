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
            "serving/bucketing.py", "serving/metrics.py",
            "serving/towers.py", "serving/plan_cache.py",
            "reliability/errors.py", "reliability/faults.py",
            "reliability/fallback.py", "reliability/__init__.py",
            "autotune/space.py", "autotune/prune.py", "autotune/generate.py",
            "autotune/catalog.py", "autotune/__init__.py",
            "serving/scheduler.py", "configs/__init__.py", "configs/base.py",
            "configs/command_r_35b.py", "configs/gemma2_9b.py",
            "configs/grok_1_314b.py", "configs/jamba_v0_1_52b.py",
            "configs/kimi_k2_1t_a32b.py", "configs/llava_next_34b.py",
            "configs/mamba2_2_7b.py", "configs/mistral_nemo_12b.py",
            "configs/tinyllama_1_1b.py", "configs/whisper_large_v3.py"]

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
                "repro_torch.kernels.winograd_gemm.bench",
                "repro_torch.serving.server", "repro_torch.serving.plan_cache",
                "repro_torch.reliability.quarantine",
                "repro_torch.reliability.fallback",
                "repro_torch.autotune.space", "repro_torch.autotune.prune",
                "repro_torch.autotune.generate",
                "repro_torch.autotune.measure",
                "repro_torch.autotune.catalog", "repro_torch.autotune.tuner",
                "repro_torch.launch.tune", "repro_torch.obs.drift",
                "repro_torch.kernels.matmul.space",
                "repro_torch.kernels.conv_im2col.space",
                "repro_torch.kernels.winograd_gemm.space",
                "repro_torch.kernels.conv_direct.space",
                "repro_torch.kernels.flash_attention.space",
                "repro_torch.kernels.layout_transform.space",
                "repro_torch.configs", "repro_torch.configs.tinyllama_1_1b",
                "repro_torch.models", "repro_torch.models.sharding",
                "repro_torch.models.common", "repro_torch.models.blocks",
                "repro_torch.models.moe", "repro_torch.models.mamba",
                "repro_torch.models.model", "repro_torch.runtime",
                "repro_torch.runtime.elastic",
                "repro_torch.runtime.serve_loop",
                "repro_torch.serving.scheduler", "repro_torch.launch.serve",
                "repro_torch.kernels.conv_im2col.kernel",
                "repro_torch.tree", "repro_torch.optim",
                "repro_torch.optim.optimizers",
                "repro_torch.optim.compression", "repro_torch.data",
                "repro_torch.data.pipeline", "repro_torch.checkpoint",
                "repro_torch.checkpoint.checkpointer",
                "repro_torch.runtime.train_loop",
                "repro_torch.launch.train", "repro_torch.launch.mesh",
                "repro_torch.runtime.pipeline_parallel",
                "repro_torch.core.sharding_select",
                "repro_torch.launch.dryrun", "repro_torch.launch.inputs",
                "repro_torch.launch.run_all"}
    assert expected <= set(rep["modules"])


def test_no_import_statement_names_jax_or_the_reference():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\b"
                     r"|from repro\.)", re.M)
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
        ROOT / "examples" / "serve_lm_torch.py",
        ROOT / "examples" / "train_lm_torch.py",
        ROOT / "examples" / "select_sharding_torch.py"]
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
    from repro_torch.serving import PlanServer
    net = alexnet(0.3)
    sel = select_sum2d(net, AnalyticCostModel())
    params = net.init_params(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_plan(sel, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProfiledCostModel(str(tmp_path / "p.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanServer(lambda s: alexnet(0.3), AnalyticCostModel())
    cnet = compile_plan(sel, params, device="cpu")
    assert cnet.device.type == "cpu"
    srv = PlanServer(lambda s: alexnet(0.3), AnalyticCostModel(),
                     device="cpu")
    assert srv.device.type == "cpu"
    srv.close()
    # the LM serving path (slice F1)
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params, params_from_numpy
    from repro_torch.runtime import ServeLoop
    cfg = get_config("tinyllama-1.1b").scaled_down(
        n_layers=2, d_model=64, d_ff=128, vocab=256)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0)
    params = init_params(cfg, 0, torch.float32, device="cpu")
    tree = {"embed": params["embed"].numpy(),
            "blocks": {"layer0": {"norm1": params["blocks"]["layer0"]
                                  ["norm1"].numpy()}}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(tree)
    assert params_from_numpy(tree, device="cpu")["embed"].device.type == \
        "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeLoop(cfg, params)
    assert ServeLoop(cfg, params, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1", "--max-new", "1"])
    assert serve.main(["--requests", "1", "--max-new", "1",
                       "--device", "cpu"]) == 0
    # the training path (slice F3)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.runtime import TrainLoopConfig, train
    shape = ShapeConfig("t", seq_len=8, global_batch=2, kind="train")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(cfg, shape, 0)
    assert make_batch(cfg, shape, 0, device="cpu")["tokens"].device.type \
        == "cpu"
    loop = TrainLoopConfig(total_steps=1, ckpt_dir=str(tmp_path / "t"),
                           log_every=0)
    opt = adamw(warmup_cosine(1e-3, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, shape, opt, loop=loop)
    assert train(cfg, shape, opt, loop=loop, device="cpu").step == 1
    argv = ["--steps", "1", "--d-model", "32", "--layers", "1", "--seq",
            "8", "--batch", "2", "--ckpt-dir", str(tmp_path / "cli")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(argv)
    assert train_cli.main(argv + ["--device", "cpu"]) == 0


class _StandInMesh:
    """A mesh's names and sizes without a world (``DeviceMesh``'s
    interface as ``ShardingPlan`` and ``ElasticController`` read it)."""

    def __init__(self, shape, names):
        self.mesh = torch.zeros(shape)
        self.mesh_dim_names = names

    def size(self, i):
        return self.mesh.shape[i]


def test_mesh_plans_are_validated_and_lm_plans_take_a_mesh():
    """The conv mesh executables validate a mesh plan as the reference
    does, here a single image that cannot be sharded (slice G1); the LM
    plan takes a named mesh and resolves the rules' specs to DTensor
    placements (slice G2), and refuses anything else."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.convnets import alexnet
    from repro_torch.core.costs import AnalyticCostModel
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.selection import select_sum2d
    from repro_torch.models import MEGATRON_RULES, ShardingPlan
    net = alexnet(0.3)
    sel = select_sum2d(net, AnalyticCostModel())
    with pytest.raises(ValueError, match="batch >= 2"):
        compile_plan(sel, net.init_params(0), batch=1, mesh=object(),
                     device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        ShardingPlan(mesh=object())
    plan = ShardingPlan(mesh=_StandInMesh((2, 4), ("data", "model")),
                        rules=MEGATRON_RULES.restrict(("data", "model")))
    spec = plan.rules.spec(("batch", "seq", "heads", "head_dim"))
    assert plan.placements(spec) == (Shard(0), Shard(2))
    # a dimension its mesh axes do not divide stays replicated
    assert plan.placements(spec, (8, 16, 6, 64)) == (Shard(0),
                                                     Replicate())


@pytest.mark.parametrize("flag", [["--mesh", "dp=2"], ["--dp-mesh", "2"]])
def test_serve_meshes_run_on_every_rank(flag):
    """``--mesh``/``--dp-mesh`` run the CLI on a world of that many ranks
    (CPU processes here) and keep the reference's argument errors."""
    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--vision-every", "2",
                       "--requests", "2", "--max-new", "1", *flag]) == 0
    with pytest.raises(SystemExit):   # a mesh shards the vision path only
        serve.main(["--device", "cpu", *flag])
    with pytest.raises(SystemExit):   # one or the other
        serve.main(["--device", "cpu", "--vision-every", "2", "--mesh",
                    "dp=2", "--dp-mesh", "2"])


def test_elastic_remesh_counts_the_world():
    """Without a process group the world is one rank; ``current()``
    builds the mesh and plan for it, and changes nothing on a second
    call.  A controller without mesh factories refuses, as the
    reference's does."""
    from repro_torch.models import MEGATRON_RULES
    from repro_torch.runtime import ElasticController
    seen = []

    def mk(n):
        seen.append(n)
        return _StandInMesh((n, 1), ("data", "model"))
    ec = ElasticController(make_mesh=mk,
                           make_rules=lambda shape: MEGATRON_RULES)
    mesh, plan, changed = ec.current()
    assert seen == [1] and plan.mesh is mesh and not changed
    assert plan.rules.get("batch") == "data"
    assert ec.current()[2] is False and ec.generation == 0
    with pytest.raises(RuntimeError, match="make_mesh"):
        ElasticController().current()
    assert ec.desired_workers(queued=10, inflight=0) == 2
