"""The port's mesh ``PlanServer`` against its meshless server and the
reference's mesh server, on the CPU.

Eight ranks of a gloo world of CPU processes (``run_spmd``) each run
the same servers on the same 16-image stream (the reference's
``tests/test_distributed.py::TestShardedPlan`` cases): a server on a
``(8,)`` ``data`` mesh, a meshless one, and two mesh servers on one
cache directory.  Held:

* the mesh fingerprint is part of the cost version every cache tier
  keys on;
* every answer of the mesh server lies within ``SELF_REL`` (1e-5) of
  the meshless server's largest magnitude (measured: 6.0e-6; each dp
  shard runs the bucket's primitives on one image where the meshless
  server runs them on eight, and their GEMMs sum in other orders)
  and within ``REF_REL`` (1e-3) of the reference's mesh server's;
* ``mesh_compiles >= 1``, and the batch-1 path (mesh-free) agrees;
* every rank gives the same answers;
* a second mesh server on the first one's cache directory solves
  nothing: its plan comes from disk (``plan_disk_hits == 1``), written
  by rank 0 alone.
"""
import numpy as np
import pytest

import _torch_mesh_cases as C
from repro_torch.launch.mesh import run_spmd

SELF_REL = 1e-5
REF_REL = 1e-3


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return C.reference("server", tmp_path_factory.mktemp("ref_server"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cache = tmp_path_factory.mktemp("mesh_plans")
    n = int(np.prod(C.SERVER_MESH[0]))
    return run_spmd(C.serve_cases, n, args=(str(cache), "cpu"),
                    device="cpu", timeout_s=60.0), cache


def _scale(outs):
    return max(float(np.abs(v).max()) for o in outs for v in o.values())


def test_mesh_fingerprint_joins_the_cache_key(ranks):
    for r in ranks[0]:
        mesh_v, plain_v = r["versions"]
        assert mesh_v == plain_v + "+mesh=cpu-data8"


def test_mesh_server_matches_plain(ranks):
    for r in ranks[0]:
        assert len(r["mesh"]) == len(r["plain"]) == 16
        scale = _scale(r["plain"])
        for got, want in zip(r["mesh"], r["plain"]):
            assert set(got) == set(want)
            for k in got:
                assert got[k].shape == want[k].shape
                assert float(np.abs(got[k] - want[k]).max()) <= \
                    SELF_REL * scale
        assert r["stats"]["mesh_compiles"] >= 1
        for k, v in r["one_mesh"].items():
            np.testing.assert_allclose(v, r["one_plain"][k], rtol=0,
                                       atol=SELF_REL * scale)


def test_mesh_server_matches_reference(ranks, reference):
    outs, meta = reference
    assert meta["mesh_compiles"] >= 1
    for r in ranks[0]:
        scale = max(float(np.abs(v).max()) for v in outs.values())
        for i, got in enumerate(r["mesh"]):
            for k, v in got.items():
                want = outs[f"{i}/{k}"]
                assert v.shape == want.shape
                assert float(np.abs(v - want).max()) <= REF_REL * scale
        assert r["stats"]["mesh_compiles"] == meta["mesh_compiles"]


def test_every_rank_answers_the_same(ranks):
    first = ranks[0][0]
    for r in ranks[0][1:]:
        for got, want in zip(r["mesh"], first["mesh"]):
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])


def test_mesh_plan_roundtrips_through_disk_cache(ranks):
    results, cache = ranks
    assert len(list(cache.glob("plan_*.json"))) == 1
    for r in results:
        assert r["disk1_solves"] == 1
        s = r["disk2_stats"]
        assert s["solves"] == 0 and s["plan_disk_hits"] == 1, s
        assert s["mesh_compiles"] >= 1, s
        for k in r["disk1"]:
            np.testing.assert_array_equal(r["disk1"][k], r["disk2"][k])
