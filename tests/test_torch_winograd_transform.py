"""The 2-D Winograd transforms (``repro_torch.kernels.winograd_transform``)
on the CPU: their plain versions, the primitives and K3's wrapper built on
them, the launch planner, and what the kernels' names must avoid.

* The primitives' new path (input transform, one product over the
  (alpha^2, M, C) packing, output transform) against the three einsums it
  replaced, on (M, C, alpha, alpha) packed weights: within 1e-5 of the
  largest magnitude, since the same f32 arithmetic is summed in another
  order (the middle product as a bmm over C instead of an einsum).
* All ten ``wino2d_*`` against the reference's primitives (its JAX einsums)
  at the sweep's scenarios, one image and a batch, within the 2e-3 of
  ``tests/test_torch_primitives.py``: F(4,3), F(6,3) and the K = 5 pairs
  lose a few bits to their transforms.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import primitives as RP
from repro.core.scenario import Scenario as RScenario
from repro_torch.core import primitives as TP
from repro_torch.core.layouts import LAYOUT_BY_NAME
from repro_torch.core.scenario import Scenario
from repro_torch.core.winograd_transforms import winograd_matrices
from repro_torch.kernels import (LAUNCH_COUNTER_OF, all_launches, common,
                                 conv_launches, expected_launches)
from repro_torch.kernels import winograd_transform as wt
from repro_torch.kernels.winograd_gemm import (bgemm_ref, conv_winograd,
                                               prepare_kernel)
from repro_torch.kernels.winograd_transform import kernel as wk

from test_torch_primitives import SCENARIOS

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-3, atol=2e-3)
#: same arithmetic, another order of the sums
SAME = 1e-5
WINO2D = [n for n in (p.name for p in TP.registry())
          if n.startswith("wino2d_")]
T_REG = {p.name: p for p in TP.registry()}
R_REG = {p.name: p for p in RP.registry()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _mk(name):
    m_, k = int(name[len("wino2d_f")]), int(name[len("wino2d_fNx")])
    return m_, k


def _einsum_wino2d(scn, m_, x, w, b):
    """The three einsums the ``wino2d`` primitives ran, on U packed as
    (M, C, alpha, alpha): x (N, C, H, W) -> (N, M, OH, OW)."""
    a = m_ + scn.k - 1
    A, G, Bt = (torch.from_numpy(np.asarray(t, np.float32))
                for t in winograd_matrices(m_, scn.k))
    U = torch.from_numpy(np.asarray(np.einsum("ar,mcrs,bs->mcab", G.numpy(),
                                              w, G.numpy()), np.float32))
    n = x.shape[0]
    oh, ow = scn.out_h, scn.out_w
    nth, ntw = -(-oh // m_), -(-ow // m_)
    ph = (nth - 1) * m_ + a - (scn.h + 2 * scn.pad)
    pw = (ntw - 1) * m_ + a - (scn.w + 2 * scn.pad)
    xp = F.pad(x, (scn.pad, scn.pad + max(pw, 0), scn.pad,
                   scn.pad + max(ph, 0)))
    d = F.unfold(xp, (a, a), stride=m_).reshape(n, scn.c, a, a, nth, ntw)
    V = torch.einsum("ai,ncijtu,bj->ncabtu", Bt, d, Bt)
    Q = torch.einsum("mcab,ncabtu->nmabtu", U, V)
    Y = torch.einsum("ap,nmabtu,bq->nmtpuq", A, Q, A)
    y = Y.reshape(n, scn.m, nth * m_, ntw * m_)[:, :, :oh, :ow]
    return y + torch.from_numpy(b)[:, None, None]


def _data(scn, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + scn.in_shape_chw).astype(np.float32)
    w = (rng.normal(size=scn.weight_shape) * 0.1).astype(np.float32)
    b = rng.normal(size=(scn.m,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("name", WINO2D)
def test_plain_path_equals_the_einsums_it_replaced(name):
    """CHW and HWC in and out, batch 1 and 3, at a ragged scenario whose
    tiles overhang the plane."""
    m_, k = _mk(name)
    p = T_REG[name]
    scn = Scenario(c=6, h=13, w=9, stride=1, k=k, m=10, pad=k // 2)
    for n in (1, 3):
        x, w, b = _data(scn, n, seed=n + m_ + k)
        want = _einsum_wino2d(scn, m_, torch.from_numpy(x), w, b).numpy()
        packed = p.prepare(scn, w, b)
        for li in ("CHW", "HWC"):
            xin = torch.from_numpy(np.stack(
                [LAYOUT_BY_NAME[li].to_memory(xi) for xi in x]))
            for lo in ("CHW", "HWC"):
                y = p.make_fused(scn, li, lo)(xin, packed).numpy()
                got = np.stack([LAYOUT_BY_NAME[lo].from_memory(yi)
                                for yi in y])
                _close(got, want, SAME)


@pytest.mark.parametrize("name", WINO2D)
def test_packing_gives_the_reference_outputs(name):
    """The (alpha^2, M, C) packing against the reference's primitive at
    every sweep scenario it supports, one image and a batch of 2."""
    tp, rp = T_REG[name], R_REG[name]
    lay = LAYOUT_BY_NAME[tp.l_in]
    scns = [s for s in SCENARIOS if tp.supports(s)]
    assert scns
    for scn in scns:
        x, w, b = _data(scn, 2, seed=7)
        packed = tp.prepare(scn, w, b)
        a = _mk(name)[0] + scn.k - 1
        assert packed["w"].shape == (a * a, scn.m, scn.c)
        assert packed["w"].is_contiguous()
        rpacked = rp.prepare(RScenario(**scn.__dict__), w, b)
        rf = rp.make(RScenario(**scn.__dict__))
        xm = np.stack([lay.to_memory(xi) for xi in x])
        batch = tp.make(scn)(torch.from_numpy(xm), packed).numpy()
        for i in range(2):
            want = np.asarray(rf(jnp.asarray(xm[i]), rpacked))
            one = tp.make(scn)(torch.from_numpy(xm[i].copy()),
                               packed).numpy()
            np.testing.assert_allclose(one, want, err_msg=f"{scn.key()}",
                                       **TOL)
            np.testing.assert_allclose(batch[i], want,
                                       err_msg=f"{scn.key()} batched", **TOL)


def _einsum_conv_winograd(x, u, b, m_, pad, out_layout):
    """K3's wrapper as it was: pad, unfold and two einsums around the
    product; x (N, C, H, W)."""
    k = 3
    n, c, h, wd = x.shape
    a = m_ + k - 1
    A, _, Bt = wt.winograd_tensors(m_, k, x.device)
    oh, ow = h + 2 * pad - k + 1, wd + 2 * pad - k + 1
    nth, ntw = -(-oh // m_), -(-ow // m_)
    ph = (nth - 1) * m_ + a - (h + 2 * pad)
    pw = (ntw - 1) * m_ + a - (wd + 2 * pad)
    xp = F.pad(x, (pad, pad + max(pw, 0), pad, pad + max(ph, 0)))
    d = F.unfold(xp, (a, a), stride=m_).reshape(n, c, a, a, nth * ntw)
    V = torch.einsum("ai,ncijt,bj->abcnt", Bt, d, Bt).reshape(
        a * a, c, n * nth * ntw)
    mo = u.shape[1]
    Q = bgemm_ref(u, V).reshape(a, a, mo, n, nth, ntw)
    if out_layout == "HWC":
        Y = torch.einsum("ap,abmntu,bq->ntpuqm", A, Q, A)
        return Y.reshape(n, nth * m_, ntw * m_, mo)[:, :oh, :ow, :] + b
    Y = torch.einsum("ap,abmntu,bq->nmtpuq", A, Q, A)
    return Y.reshape(n, mo, nth * m_, ntw * m_)[:, :, :oh, :ow] + \
        b[:, None, None]


@pytest.mark.parametrize("m_", [2, 4])
@pytest.mark.parametrize("li,lo", [("CHW", "CHW"), ("HWC", "HWC"),
                                   ("CHW", "HWC"), ("HWC", "CHW")])
def test_conv_winograd_equals_the_einsums_it_replaced(m_, li, lo):
    rng = np.random.default_rng(m_)
    x = torch.from_numpy(rng.normal(size=(2, 8, 13, 9)).astype(np.float32))
    w = (rng.normal(size=(12, 8, 3, 3)) * 0.1).astype(np.float32)
    b = torch.from_numpy(rng.normal(size=(12,)).astype(np.float32))
    u = prepare_kernel(w, m_)
    xin = x.permute(0, 2, 3, 1).contiguous() if li == "HWC" else x
    got = conv_winograd(xin, u, b, m_=m_, k=3, pad=1, in_layout=li,
                        out_layout=lo)
    want = _einsum_conv_winograd(x, u, b, m_, 1, lo)
    _close(got.numpy(), want.numpy(), SAME)


@pytest.mark.parametrize("what", ["stride2", "f7x3", "f6x5", "f64", "f16"])
def test_wrappers_refuse_what_the_kernels_do_not_take(what):
    x = torch.zeros((1, 2, 8, 8))
    q = torch.zeros((36, 3, 4))
    kw = dict(m_=4, k=3)
    if what == "stride2":
        with pytest.raises(ValueError, match="stride 1"):
            wt.input_transform(x, **kw, pad=1, stride=2)
        return
    if what.startswith("f") and "x" in what:
        kw = dict(m_=int(what[1]), k=int(what[3]))
        err = ValueError
    else:
        x, q = x.to(getattr(torch, {"f64": "float64",
                                    "f16": "float16"}[what])), \
            q.to(torch.float64 if what == "f64" else torch.float16)
        err = TypeError
    with pytest.raises(err):
        wt.input_transform(x, **kw, pad=1)
    with pytest.raises(err):
        wt.output_transform(q, torch.zeros(3, dtype=q.dtype), **kw, n=1,
                            oh=8, ow=8)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    scn = Scenario(c=3, h=7, w=7, stride=1, k=3, m=5)
    common.reset_launch_counts()
    x, w, b = _data(scn, 2, seed=3)
    v = wt.input_transform(torch.from_numpy(x), m_=2, k=3, pad=1)
    assert v.shape == (16, 3, 2 * 16) and v.is_contiguous()
    y = wt.output_transform(torch.zeros((16, 5, 32)), torch.ones(5), m_=2,
                            k=3, n=2, oh=7, ow=7, out_layout="HWC")
    assert y.shape == (2, 7, 7, 5) and bool((y == 1).all())
    assert common.launch_counts() == {}


def _global_names():
    """The kernels' device names as the profiler reports them: each
    ``__global__`` template at each (m, k) the wrapper launches."""
    src = (ROOT / "src/repro_torch/csrc/winograd_transform.cu").read_text()
    ns = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                    r"(\w+)", src)
    assert len(ns) == 2
    return [f"void (anonymous namespace)::{n}<{m}, {k}>(float const*, "
            f"float*, (anonymous namespace)::Geom)" for n in ns
            for m, k in wk.PAIRS]


def test_kernel_names_stay_outside_kernel_roofline():
    """``kernel_roofline`` counts the port's K3 launches against the K3
    convolutions' bound; the transforms ran as PyTorch kernels before
    and must not join that count."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "kernel_roofline", ROOT / "bench/metrics/kernel_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in _global_names():
        assert not mod.PORT_KERNEL.search(name), name
    # the pattern does catch the port's own kernels
    assert mod.PORT_KERNEL.search("void (anonymous namespace)::conv_kernel<>")


#: (C or M, H, W, m, k) at VGG-16's and AlexNet's Winograd convolutions,
#: and ragged planes whose tiles overhang
_PLAN_SHAPES = [(64, 224, 224, 6, 3), (128, 112, 112, 6, 3),
                (256, 56, 56, 6, 3), (512, 28, 28, 6, 3),
                (512, 14, 14, 6, 3), (512, 14, 14, 4, 3),
                (256, 56, 56, 4, 3), (64, 224, 224, 2, 3),
                (256, 27, 27, 4, 5), (96, 27, 27, 2, 5),
                (384, 13, 13, 2, 3), (5, 13, 9, 6, 3), (3, 7, 7, 4, 5),
                (1, 1500, 1500, 2, 3)]


@pytest.mark.parametrize("c,h,w,m_,k", _PLAN_SHAPES)
@pytest.mark.parametrize("n", [1, 16])
def test_plans_fit_the_kernel(c, h, w, m_, k, n):
    """Every plan is one the C entry launches: threads a multiple of 32
    up to 256, shared memory within 48 KB, at most 65535 channel groups;
    its blocks cover every tile once; where C is the unit stride a block
    takes a 32-byte sector of channels."""
    oh, ow, nth, ntw = wt.tiles(h, w, m_, k, k // 2)
    for output in (False, True):
        for chan_fast in (False, True):
            p = wk.plan(output, n, c, nth, ntw, m_, k, chan_fast)
            assert 32 <= p.threads <= wk.ITEMS and p.threads % 32 == 0
            assert p.smem == wk.smem_bytes(output, m_, k, p.rows, p.cols,
                                           p.chans) <= wk.SMEM_BYTES
            assert -(-c // p.chans) <= 65535
            assert p.rows <= nth and p.cols <= min(ntw, wk.MAX_COLS)
            assert p.blocks == n * -(-nth // p.rows) * -(-ntw // p.cols) \
                * -(-c // p.chans)
            if chan_fast:
                assert p.chans >= min(c, wk.SECTOR_CHANS)


def test_large_planes_fill_the_card():
    """VGG-16's conv1_2 at batch 1 (F(6,3), CHW): whole tile rows of one
    channel, enough blocks for two a multiprocessor."""
    p = wk.plan(False, 1, 64, 38, 38, 6, 3, False)
    assert (p.cols, p.chans) == (38, 1)
    assert p.blocks >= wk.BLOCKS_PER_SM * wk.SMS


def test_transform_bytes():
    scn = Scenario(c=64, h=224, w=224, stride=1, k=3, m=64, n=16)
    fin, fout = wt.transform_bytes(scn, 6)
    v = 64 * 16 * 38 * 38
    assert fin == 4 * (16 * 64 * 224 * 224 + v * 64)
    assert fout == 4 * (v * 64 + 16 * 64 * 224 * 224)


def test_expected_transform_launches_count_the_2d_winograd_convs():
    """``all_launches``: two transforms per conv given to a ``wino2d_*`` or
    ``pallas_wino_*``, none for the 1-D Winograd or any other family,
    beside ``expected_launches``' kernel counters."""
    from repro_torch.convnets import alexnet
    from repro_torch.core.costs import AnalyticCostModel
    from repro_torch.core.selection import select_fixed
    net = alexnet(0.25)
    cost = AnalyticCostModel()
    want = {"wino2d_f4x5_chw": 2, "pallas_wino_f4x3_chw": 2,
            "wino1d_f2x3_chw": 0, "im2col_xla_n_chw": 0}
    for name, per in want.items():
        prim, other = T_REG[name], T_REG["im2col_xla_n_chw"]
        pick = {nd.id: prim if prim.supports(nd.scn) else other
                for nd in net.conv_nodes()}
        n = sum(p is prim for p in pick.values())
        assert n, name
        sel = select_fixed(net, cost, pick, f"pinned_{name}")
        got = all_launches(sel)
        assert got == {**expected_launches(sel),
                       **({wt.COUNTER: per * n} if per else {})}, name


@pytest.mark.parametrize("name,want", [
    ("wino2d_f6x3_chw", {"winograd_transform": 2}),
    ("wino2d_f2x5_hwc", {"winograd_transform": 2}),
    ("pallas_wino_f2x3_chw", {"winograd_gemm": 1, "winograd_transform": 2}),
    ("pallas_wino_f4x3_chw@t64x64s2",
     {"winograd_gemm": 1, "winograd_transform": 2}),
    ("pallas_direct_hwc", {"conv_direct": 1}),
    ("wino1d_f2x3_chw", {}), ("im2col_xla_n_chw", {})])
def test_conv_launches_of_one_conv(name, want):
    """One conv's launches by counter, a tuned variant's as its base's."""
    assert conv_launches(name) == want
    base = name.split("@")[0]
    assert {k: v for k, v in want.items() if k != wt.COUNTER} == \
        ({LAUNCH_COUNTER_OF[base]: 1} if base in LAUNCH_COUNTER_OF else {})


@pytest.mark.parametrize("mk", wk.PAIRS, ids=lambda p: f"f{p[0]}x{p[1]}")
@pytest.mark.parametrize("lo", ["CHW", "HWC"])
def test_winograd_conv_is_the_transforms_around_its_gemm(mk, lo):
    """``winograd_conv``: the input transform, the GEMM it is given, the
    output transform, on a ragged plane whose tiles overhang."""
    m_, k = mk
    rng = np.random.default_rng(m_ * 10 + k)
    x = torch.from_numpy(rng.normal(size=(2, 5, 13, 9)).astype(np.float32))
    u = torch.from_numpy(rng.normal(
        size=((m_ + k - 1) ** 2, 7, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(7,)).astype(np.float32))
    pad = k // 2
    oh, ow = 13 + 2 * pad - k + 1, 9 + 2 * pad - k + 1
    got = wt.winograd_conv(x, lambda v: torch.bmm(u, v), b, m_=m_, k=k,
                           pad=pad, out_layout=lo)
    v = wt.input_transform_ref(x, m_, k, pad)
    want = wt.output_transform_ref(torch.bmm(u, v), b, m_, k, 2, oh, ow, lo)
    assert torch.equal(got, want)
