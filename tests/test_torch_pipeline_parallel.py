"""The port's GPipe schedule (``runtime.pipeline_apply``) against a
sequential loop and against the reference's, on the CPU.

``pipeline_apply`` runs in gloo worlds of CPU processes (``run_spmd``),
one process per stage; the reference's runs once, in one subprocess on
8 fake CPU devices (``_torch_mesh_cases.reference``).  The cases are the
reference's (``tests/test_distributed.py::TestPipelineParallel``):
S = 4 stages over 8 microbatches, S = 1 (the pipeline is the stage
function) and one microbatch (the pure fill-drain bubble).  Each stage
computes ``tanh(x @ w[s])``: every rank's result must lie within
``SEQ_TOL`` (1e-5) of a sequential loop over the stages, as the
reference's tests hold it, and within ``REF_TOL`` of the reference's
pipeline.  Measured: both distances are 0 (the same products in the same
order; a stage's microbatch is computed as the loop computes it).
"""
import numpy as np
import pytest
import torch

import _torch_mesh_cases as C
from repro.runtime.pipeline_parallel import pipeline_ticks as r_ticks
from repro_torch.launch.mesh import run_spmd
from repro_torch.runtime.pipeline_parallel import pipeline_ticks

SEQ_TOL = 1e-5
REF_TOL = 1e-5
#: the worlds: stage count -> its cases
WORLDS = {4: ("s4_m8", "s4_m1"), 1: ("s1_m4",)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    outs, _ = C.reference("pipe", tmp_path_factory.mktemp("ref_pipe"))
    return outs


@pytest.fixture(scope="module")
def port_worlds():
    done = {}

    def get(s):
        if s not in done:
            done[s] = run_spmd(C.pipe_cases, s, args=(WORLDS[s], "cpu"),
                               device="cpu", timeout_s=60.0)
        return done[s]
    return get


def _sequential(case):
    w, x = C.pipe_operands(case)
    y = torch.from_numpy(x)
    for s in range(w.shape[0]):
        y = torch.tanh(y @ torch.from_numpy(w[s]))
    return y.numpy()


@pytest.mark.parametrize("case", list(C.PIPE_CASES))
def test_pipeline_matches_sequential(case, port_worlds):
    ranks = port_worlds(C.PIPE_CASES[case][0])
    want = _sequential(case)
    for got in ranks:      # every rank holds the last stage's outputs
        assert got[case].shape == want.shape
        assert float(np.abs(got[case] - want).max()) <= SEQ_TOL


@pytest.mark.parametrize("case", list(C.PIPE_CASES))
def test_pipeline_matches_reference(case, port_worlds, reference):
    ranks = port_worlds(C.PIPE_CASES[case][0])
    for got in ranks:
        assert float(np.abs(got[case] - reference[case]).max()) <= REF_TOL


@pytest.mark.parametrize("s,n_micro", [(1, 1), (4, 8), (2, 1), (3, 5)])
def test_pipeline_ticks_formula(s, n_micro):
    """Fill-drain schedule length: T = n_micro + S - 1, as the
    reference's."""
    assert pipeline_ticks(s, n_micro) == r_ticks(s, n_micro) == \
        n_micro + s - 1


@pytest.mark.parametrize("s,n_micro", [(0, 4), (4, 0), (-1, 1)])
def test_pipeline_ticks_raises_as_the_reference(s, n_micro):
    with pytest.raises(ValueError) as r_err:
        r_ticks(s, n_micro)
    with pytest.raises(ValueError) as t_err:
        pipeline_ticks(s, n_micro)
    assert str(t_err.value) == str(r_err.value)
