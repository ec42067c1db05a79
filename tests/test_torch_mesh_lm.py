"""The port's LM on a mesh (``ShardingPlan(mesh=)`` over DTensor) against
the reference's GSPMD runs, on the CPU.

The port's side runs in gloo worlds of CPU processes (``run_spmd``), one
world per mesh: {data: 4, model: 2}, {data: 2, model: 4}, {data: 2,
model: 2} and {model: 4}.  The reference's side runs once, in one
subprocess on 8 fake CPU devices (``_torch_mesh_lm_cases.reference``),
and hands the port its parameters.  The cases
(``_torch_mesh_lm_cases.LM_CASES``):

* the reference's two ``TestShardedModel`` cases: the dense ``loss_fn``
  on 4 x 2 and the MoE ``forward_train`` on 2 x 4;
* prefill plus 3 decode steps of the dense model on 2 x 2, and one
  scaled configuration per other family (ssm, hybrid, vlm: prefill and
  decode; encdec: the training forward and prefill);
* the kv-replicated GQA case: 4 heads on 2 kv heads over ``model: 4``
  (each rank's q head meets the kv head of its global index), under
  ``attn_impl`` "xla" and "flash" (the plain version on the CPU; the
  reference's Pallas kernel in interpret mode).

Each output is held to the reference's mesh output at ``REL`` (1e-4 of
its largest magnitude) and to the port's own run of the same parameters
without a mesh at ``REL``, with three measured exceptions (the numbers
are in ``_torch_mesh_lm_cases``): the encoder-decoder at ``REL_ENCDEC``
(3e-4), as ``tests/test_torch_models.py`` explains, and its training
forward against the reference at ``REL_ENCDEC_FWD_REF`` (3e-3: the
reference's own GSPMD logits lie 1.37e-3 from a float64 evaluation, the
port's 2.1e-4); the MoE forward against the reference at
``REL_MOE_REF`` (2e-4: the reference's GSPMD run lies 4.9e-5 and the
port's single-device run 5.7e-5 from float64, 1.08e-4 apart).

Also: the gradients of ``loss_and_grads`` on a mesh against one device
(dense, the all-to-all MoE, hybrid, the kv-replicated GQA case); two
mesh axes on one dimension split as JAX's ``PartitionSpec`` splits it;
``moe_ffn_alltoall`` against the reference's ``shard_map``
schedule on the same slabs, at a capacity that drops pairs (the same
keep/drop set on every slab, the output at ``REL``);
``compressed_psum_tree`` without noise within 1e-6 relative of the
reference's, with stochastic rounding within 0.05 of the exact mean
(the reference's bound); ``ElasticController.current()`` as the
reference's ``TestElastic``; the serve CLI's ``--mesh dp=2``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_mesh_lm_cases as C
from repro_torch.launch.mesh import run_spmd

TIMEOUT_S = 120.0
WORLD_SIZE = {"data4_model2": 8, "data2_model4": 8, "data2_model2": 4,
              "model4": 4}


@pytest.fixture(scope="module")
def ref_npz(tmp_path_factory):
    return C.reference(tmp_path_factory.mktemp("ref_lm"))


@pytest.fixture(scope="module")
def ref(ref_npz):
    with np.load(ref_npz) as z:
        return {k: z[k] for k in z.files}


_WORLDS = {}


def _world(key, ref_npz):
    if key not in _WORLDS:
        _WORLDS[key] = run_spmd(C.lm_world, WORLD_SIZE[key],
                                args=(C.WORLDS[key], ref_npz, "cpu"),
                                device="cpu", timeout_s=TIMEOUT_S)
    return _WORLDS[key]


def _world_of(case):
    return next(k for k, v in C.WORLDS.items() if case in v)


MODEL_CASES = [c for c in C.LM_CASES]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_mesh_model_matches_reference_and_single_device(case, ref_npz, ref):
    ranks = _world(_world_of(case), ref_npz)
    got = ranks[0][case]
    keys = sorted(got["mesh"])
    assert keys and keys == sorted(got["plain"])
    for k in keys:
        want = ref[f"{case}/{k}"]
        d_ref = C.rel_dist(got["mesh"][k], want)
        assert d_ref <= C.ref_tolerance(case, k), \
            f"{case} {k}: {d_ref:.3e} from the reference"
        d_self = C.rel_dist(got["mesh"][k], got["plain"][k])
        assert d_self <= C.self_tolerance(case), \
            f"{case} {k}: {d_self:.3e} from one device"
        for r in ranks[1:]:   # every rank holds the same full values
            np.testing.assert_array_equal(r[case]["mesh"][k],
                                          got["mesh"][k])


@pytest.mark.parametrize("case", sorted(C.GRAD_CASES))
def test_mesh_gradients_match_single_device(case, ref_npz):
    """``loss_and_grads`` on a mesh (each gradient takes its parameter's
    placements) against one device: the loss within 1e-6 relative, each
    gradient leaf within the arch's tolerance of its largest magnitude
    (``tests/test_torch_train.py``'s ``GRAD_REL``)."""
    tol = C.GRAD_CASES[case][-1]
    for r in _world(_world_of(case), ref_npz):
        g = r[case]
        assert abs(g["loss"] - g["loss0"]) <= 1e-6 * abs(g["loss0"]), g
        assert g["grad"] <= tol, (case, g)


def test_alltoall_moe_matches_reference_schedule(ref_npz, ref):
    ranks = _world("data2_model2", ref_npz)
    drops = 0
    for r in ranks:
        a = r["alltoall"]
        want = ref[f"alltoall/keep{a['rank']}"]
        np.testing.assert_array_equal(a["keep"], want)
        drops += int((~want).sum())
        d = C.rel_dist(a["y"], ref["alltoall/y"])
        assert d <= C.REL, f"rank {a['rank']}: {d:.3e}"
    assert drops > 0, "the case must drop pairs"


def test_compressed_psum_tree(ref_npz, ref):
    ranks = _world("data2_model2", ref_npz)
    g = C.compress_operands()
    mean = g.mean(axis=0)
    for r in ranks:
        c = r["compress"]
        assert c["world"] == 4
        want = ref["compress/exact"]
        d = np.abs(c["exact"] - want).max() / np.abs(want).max()
        assert d <= 1e-6, d
        rel = np.linalg.norm(c["noisy"] - mean) / np.linalg.norm(mean)
        assert rel < 0.05, rel
    # the noisy results are one all-reduce: the same on every rank
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["compress"]["noisy"],
                                      ranks[0]["compress"]["noisy"])


def test_two_mesh_axes_on_one_dimension_split_as_jax_does(ref_npz, ref):
    """``("pod", "data")`` on the batch: DTensor splits it in mesh order,
    JAX's PartitionSpec major to minor; every device gets the same
    rows in both."""
    for r in _world("data2_model2", ref_npz):
        t = r["two_axes"]
        p, d = t["coords"]
        np.testing.assert_array_equal(t["rows"], ref[f"two_axes/{p}{d}"])


def test_elastic_controller_current(ref_npz):
    for r in _world("data2_model2", ref_npz):
        e = r["elastic"]
        assert e["changed"] == (False, False) and e["generation"] == 0
        assert e["shape"] == (2, 2) and e["plan_mesh"]
        assert e["batch_rule"] == "data"   # ("pod", "data") restricted


def test_serve_cli_mesh_dp2():
    """The CLI in a process of its own (its ranks fork from a fork server
    of its own, whose output it owns)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(C.REPO / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--requests", "8", "--max-new", "3", "--vision-every", "1",
         "--mesh", "dp=2"], capture_output=True, text=True, timeout=300,
        env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert out.count("served 8 requests") == 1, out   # rank 0 alone
    line = next(ln for ln in out.splitlines()
                if ln.startswith("plan cache:"))
    n = int(line.split(" mesh-sharded")[0].rsplit(", ", 1)[1])
    assert n >= 1, line


def test_a_failing_rank_fails_the_world():
    """No fallback: a rank that raises inside the LM mesh path ends its
    world with its traceback."""
    with pytest.raises(RuntimeError, match="rank .* failed"):
        run_spmd(C.lm_world, 4, args=(("no_such_case",), None, "cpu"),
                 device="cpu", timeout_s=TIMEOUT_S)
