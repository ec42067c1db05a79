"""The port's primitive registry against the reference's.

The PBQP choice space is the registry, so the port's must be the
reference's: the same names, families, native and fusable layouts and
``supports`` truth table.  Numerically, every primitive of the port
(the kernel ones through their plain versions on the CPU) matches the
numpy oracle ``ref_conv`` and the reference's own primitive, whose
Pallas kernels run in interpret mode.  Inputs come from numpy and a
seed; both packages see the same arrays.

Tolerance 2e-3 (rtol = atol), the reference's own for primitives
against ``ref_conv``: Winograd F(4,3)/F(6,3) and the FFT routines lose a
few bits to their transforms.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.convnets import NETWORKS as R_NETWORKS
from repro.core import primitives as RP
from repro.core.layouts import LAYOUT_BY_NAME
from repro.core.scenario import Scenario as RScenario
from repro_torch.core import primitives as TP
from repro_torch.core.scenario import Scenario, ref_conv

TOL = dict(rtol=2e-3, atol=2e-3)

#: tests/test_primitives.py's sweep
SCENARIOS = [
    Scenario(c=8, h=9, w=11, stride=1, k=3, m=16),
    Scenario(c=16, h=14, w=14, stride=1, k=3, m=8),
    Scenario(c=8, h=13, w=9, stride=2, k=3, m=8),
    Scenario(c=4, h=12, w=12, stride=1, k=5, m=8),
    Scenario(c=3, h=27, w=27, stride=2, k=5, m=16, pad=2),
    Scenario(c=8, h=10, w=10, stride=1, k=1, m=24, pad=0),
    Scenario(c=16, h=7, w=7, stride=1, k=1, m=8, pad=0),
    Scenario(c=3, h=31, w=31, stride=4, k=11, m=8, pad=0),  # AlexNet conv1
    Scenario(c=8, h=8, w=8, stride=1, k=7, m=8),
    Scenario(c=8, h=16, w=24, stride=1, k=3, m=32),  # non-square
]

T_REG = {p.name: p for p in TP.registry()}
R_REG = {p.name: p for p in RP.registry()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    PyTorch's default of one thread per core would oversubscribe the
    machine under the timing-sensitive tests of the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net_scenarios():
    seen = {}
    for name in ("alexnet", "googlenet", "vgg-a", "vgg-c", "vgg-e"):
        for node in R_NETWORKS[name](1.0).conv_nodes():
            seen[node.scn.key()] = node.scn
    return list(seen.values())


def _data(scn, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=scn.in_shape_chw).astype(np.float32)
    w = (rng.normal(size=scn.weight_shape) * 0.1).astype(np.float32)
    b = rng.normal(size=(scn.m,)).astype(np.float32)
    return x, w, b


def _run_port(p, scn, x, w, b, l_in=None, l_out=None):
    packed = p.prepare(scn, w, b)
    xin = torch.from_numpy(LAYOUT_BY_NAME[l_in or p.l_in].to_memory(x)
                           .copy())
    y = p.make_fused(scn, l_in, l_out)(xin, packed).numpy()
    return LAYOUT_BY_NAME[l_out or p.l_out].from_memory(y)


def _run_ref(p, scn, x, w, b, l_in=None, l_out=None):
    packed = p.prepare(RScenario(**scn.__dict__), w, b)
    xin = jnp.asarray(LAYOUT_BY_NAME[l_in or p.l_in].to_memory(x))
    y = np.asarray(p.make_fused(RScenario(**scn.__dict__), l_in, l_out)(
        xin, packed))
    return LAYOUT_BY_NAME[l_out or p.l_out].from_memory(y)


def test_registry_names_families_and_layouts_match():
    assert list(T_REG) == list(R_REG)
    counts = collections.Counter(p.family for p in TP.registry())
    assert counts == {"direct": 17, "im2": 17, "winograd": 18, "fft": 9,
                      "kn2": 6, "pallas": 5}
    for name, tp in T_REG.items():
        rp = R_REG[name]
        assert (tp.family, tp.l_in, tp.l_out, tp.fusable_in, tp.fusable_out,
                tp.params, tp.fused is None) == \
            (rp.family, rp.l_in, rp.l_out, rp.fusable_in, rp.fusable_out,
             rp.params, rp.fused is None), name
        # the kernel primitives are tagged for what they are
        want = tuple("kernel" if t == "tpu-only" else t for t in rp.tags)
        assert tp.tags == want, name


def test_supports_truth_table_matches():
    scns = SCENARIOS + _net_scenarios()
    for scn in scns:
        rscn = RScenario(**scn.__dict__)
        got = [p.name for p in TP.primitives_for(scn)]
        want = [p.name for p in RP.primitives_for(rscn)]
        assert got == want, scn.key()


@pytest.mark.parametrize("scn", SCENARIOS, ids=lambda s: s.key())
def test_every_port_primitive_matches_ref_conv(scn):
    x, w, b = _data(scn)
    want = ref_conv(x, w, b, scn.stride, scn.pad)
    prims = TP.primitives_for(scn)
    assert prims
    for p in prims:
        got = _run_port(p, scn, x, w, b)
        assert got.shape == want.shape, p.name
        np.testing.assert_allclose(got, want, err_msg=p.name, **TOL)


@pytest.mark.parametrize("family", ["direct", "im2", "kn2", "winograd",
                                    "fft", "pallas"])
def test_each_primitive_matches_the_reference_primitive(family):
    """Every primitive of the family, on the first sweep scenario it
    supports."""
    for name, rp in R_REG.items():
        if rp.family != family:
            continue
        scn = next(s for s in SCENARIOS if T_REG[name].supports(s))
        x, w, b = _data(scn, seed=1)
        want = _run_ref(rp, scn, x, w, b)
        got = _run_port(T_REG[name], scn, x, w, b)
        np.testing.assert_allclose(got, want, err_msg=f"{name} on "
                                   f"{scn.key()}", **TOL)


@pytest.mark.parametrize("name", [n for n in T_REG if n.startswith("pallas")])
def test_kernel_primitives_fused_layouts_match_the_reference(name):
    tp, rp = T_REG[name], R_REG[name]
    scn = Scenario(c=8, h=9, w=11, stride=1,
                   k=1 if "pw" in name else 3, m=16)
    x, w, b = _data(scn, seed=2)
    for li in (tp.l_in,) + tp.fusable_in:
        for lo in (tp.l_out,) + tp.fusable_out:
            got = _run_port(tp, scn, x, w, b, li, lo)
            want = _run_ref(rp, scn, x, w, b, li, lo)
            np.testing.assert_allclose(got, want, err_msg=f"{li}->{lo}",
                                       **TOL)


def test_generic_fused_path_matches_the_reference():
    scn = SCENARIOS[0]
    x, w, b = _data(scn, seed=3)
    for name in ("im2col_xla_n_chw", "wino2d_f2x3_hwc", "pw_gemm_n_chw"):
        scn_ = SCENARIOS[5] if name.startswith("pw") else scn
        x_, w_, b_ = _data(scn_, seed=3)
        for li, lo in (("HWC", "HCW"), ("HWC8", "CHW"), ("CWH", "HWC8")):
            got = _run_port(T_REG[name], scn_, x_, w_, b_, li, lo)
            want = _run_ref(R_REG[name], scn_, x_, w_, b_, li, lo)
            np.testing.assert_allclose(got, want, err_msg=f"{name} {li}",
                                       **TOL)


def test_batched_call_equals_per_image_calls():
    scn = SCENARIOS[1]
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(3,) + scn.in_shape_chw).astype(np.float32)
    _, w, b = _data(scn)
    for name in ("sum2d", "kn2col_scan_hwc", "direct_blocked_hwc8",
                 "fft1d_sum_ex_chw", "pallas_direct_hwc"):
        p = T_REG[name]
        lay = LAYOUT_BY_NAME[p.l_in]
        packed = p.prepare(scn, w, b)
        f = p.make(scn)
        batch = torch.from_numpy(np.stack([lay.to_memory(x) for x in xs]))
        got = f(batch, packed)
        for i in range(3):
            one = f(torch.from_numpy(lay.to_memory(xs[i]).copy()), packed)
            np.testing.assert_allclose(got[i].numpy(), one.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


def test_convert_layout_matches_the_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 6, 10)).astype(np.float32)
    for layout in ("CHW", "HWC", "HCW", "CWH", "HWC8"):
        got = TP.convert_layout(torch.from_numpy(x), "CHW", layout)
        want = np.asarray(RP.convert_layout(jnp.asarray(x), "CHW", layout))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.is_contiguous()
        back = TP.convert_layout(got[None].expand(2, *got.shape), layout,
                                 "CHW")
        np.testing.assert_array_equal(back[1].numpy(), x)


def test_extension_hooks_rotate_the_token():
    extra = TP.Primitive("ext_sum2d", "direct", "CHW", "CHW",
                         T_REG["sum2d"].supports, T_REG["sum2d"].prepare,
                         T_REG["sum2d"].make)
    try:
        TP.register_extension("t", [extra], token="abc")
        assert TP.extension_token() == "t:abc"
        assert TP.registry()[-1] is extra
        with pytest.raises(ValueError, match="duplicate"):
            TP.register_extension("u", [extra])
    finally:
        TP.clear_extensions()
    assert TP.extension_token() == "" and len(TP.registry()) == 72
