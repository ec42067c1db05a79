"""Each hand-written CUDA kernel against its plain PyTorch version, on
the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  This
file imports no JAX (the card's machine has none); run it there with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_card.py

Tolerances: f32 within 1e-3 of the largest plain magnitude (TF32 off;
the kernel and cuBLAS sum in different orders), bf16 and f16 within 2e-2
(one rounding of the output to 8 or 11 mantissa bits).  The layout
transforms copy bits and must be exact; flash attention in f32 within
1e-5 of the largest plain magnitude (other summation orders over D and
Lk terms, a few ulps), at every head dim (padded to an instantiated
width, or sliced above 256).
The whole convolutions (the code around the kernels: padding, patch
gathers, Winograd transforms, crops) are held to the same 1e-3 against
an f64 ``F.conv2d``.  The GEMM and the direct conv sum their cluster's
K splits in a fixed order, so a call repeated gives the same bits.

``compile_plan(jit=True)`` captures AlexNet's forward as a CUDA graph:
its outputs must be the eager walk's bits, at batch 1 and 8, and its
capture must count one launch per kernel conv; the ``PlanServer``
serving such graphs must answer with the eager plan's bits while its
worker pool captures other buckets, and release a graph it evicts.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import common, expected_launches
from repro_torch.kernels.conv_direct import (conv_direct, conv_direct_ref,
                                             conv_plan)
from repro_torch.kernels.conv_im2col import conv_im2col
from repro_torch.kernels.flash_attention import (attention_plan,
                                                 flash_attention,
                                                 flash_attention_cuda,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.plan import make_plan
from repro_torch.kernels.layout_transform import ops as lt_ops
from repro_torch.kernels.layout_transform import ref as lt_ref
from repro_torch.kernels.matmul import (matmul, matmul_plan, matmul_ref,
                                       plan_gemm)
from repro_torch.kernels.matmul import kernel as mm_kernel
from repro_torch.kernels.winograd_gemm import (bgemm_ref, conv_winograd,
                                               prepare_kernel, winograd_bgemm)


def _data(seed, *shapes, scale=None):
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if scale:
        out[1] = out[1] * np.float32(scale)
    return out


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    with common.true_f32():
        yield torch.device("cuda")


def _conv64(x, w, b, stride, pad):
    """The f64 convolution every whole conv is held to: x (N, C, H, W),
    w (M, C, K, K)."""
    return F.conv2d(x.double(), w.double(), b.double(), stride, pad)


@pytest.mark.gpu
class TestOnCard:
    def _close(self, got, want, tol):
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max())

    @pytest.mark.parametrize("lhs", ["mk", "km"])
    @pytest.mark.parametrize("out", ["mn", "nm"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
    def test_matmul(self, cuda, lhs, out, dtype):
        x, y, b = (torch.from_numpy(a).to(cuda, dtype) for a in
                   _data(2, (130, 257), (257, 129), (129,)))
        xs = x.T.contiguous() if lhs == "km" else x
        kw = dict(fuse_relu=True, lhs_layout=lhs, out_layout=out)
        common.reset_launch_counts()
        got = matmul(xs, y, b, **kw)
        assert common.launch_counts() == {"matmul": 1}
        self._close(got, matmul_ref(xs, y, b, **kw),
                    1e-3 if dtype == torch.float32 else 2e-2)

    def test_winograd_gemm(self, cuda):
        u, v = (torch.from_numpy(a).to(cuda) for a in
                _data(3, (36, 256, 384), (2, 36, 384, 16)))
        self._close(winograd_bgemm(u, v), bgemm_ref(u, v), 1e-3)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    def test_winograd_gemm_2byte(self, cuda, dtype):
        """bf16 and f16 operands: the f32 mainloop, loaded through
        registers, Q rounded once to the operands' dtype; U packed M
        contiguous, V with 8 images folded into N."""
        w, v = _data(18, (256, 384, 3, 3), (36, 384, 8 * 16))
        u = prepare_kernel(w * np.float32(0.05), 4).to(cuda, dtype)
        v = torch.from_numpy(v).to(cuda, dtype)
        common.reset_launch_counts()
        got = winograd_bgemm(u, v)
        assert common.launch_counts() == {"winograd_gemm": 1}
        assert got.dtype == dtype
        self._close(got, bgemm_ref(u, v), 2e-2)
        assert torch.equal(got, winograd_bgemm(u, v))

    @pytest.mark.parametrize("batch", [1, 8])
    @pytest.mark.parametrize("m_", [2, 4])
    @pytest.mark.parametrize("m,c", [(384, 256), (384, 384), (256, 384)])
    def test_winograd_gemm_alexnet(self, cuda, m, c, m_, batch):
        """AlexNet's conv3-conv5 (13 x 13 out): U packed as
        ``prepare_kernel`` packs it, V with the images folded into N;
        the same bits on a repeated call (split-K sums in rank order)."""
        p, t = (m_ + 2) ** 2, (-(-13 // m_)) ** 2
        w, v = _data(15, (m, c, 3, 3), (p, c, batch * t))
        u = prepare_kernel(w, m_).to(cuda)
        v = torch.from_numpy(v).to(cuda)
        common.reset_launch_counts()
        got = winograd_bgemm(u, v)
        assert common.launch_counts() == {"winograd_gemm": 1}
        self._close(got, bgemm_ref(u, v), 1e-3)
        assert torch.equal(got, winograd_bgemm(u, v))

    @pytest.mark.parametrize("n", [None, 1, 3])
    def test_winograd_gemm_ragged(self, cuda, n):
        """M, C and N not multiples of 4 (4-byte copies); the 4-D
        (images, P, C, T) form at 1 and 3 images."""
        u, v = (torch.from_numpy(a).to(cuda) for a in
                _data(16, (16, 77, 45), (n or 1, 16, 45, 51)))
        v = v[0] if n is None else v
        got = winograd_bgemm(u, v)
        self._close(got, bgemm_ref(u, v), 1e-3)
        assert torch.equal(got, winograd_bgemm(u, v))

    @pytest.mark.parametrize("li", ["CHW", "HWC"])
    @pytest.mark.parametrize("lo", ["CHW", "HWC"])
    def test_conv_direct(self, cuda, li, lo):
        x, w, b = (torch.from_numpy(a).to(cuda) for a in
                   _data(4, (2, 3, 63, 63), (11, 11, 3, 16), (16,), scale=0.1))
        if li == "HWC":
            x = x.permute(0, 2, 3, 1).contiguous()
        kw = dict(stride=4, pad=0, in_layout=li, out_layout=lo)
        self._close(conv_direct(x, w, b, **kw), conv_direct_ref(x, w, b, **kw),
                    1e-3)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    @pytest.mark.parametrize("li,lo", [("CHW", "HWC"), ("HWC", "CHW")])
    def test_conv_direct_2byte(self, cuda, li, lo, dtype):
        """AlexNet's conv2 in bf16 and f16: the gathered operand through
        registers, 2 bytes an element."""
        x, w, b = (torch.from_numpy(a).to(cuda, dtype) for a in
                   _data(19, (2, 96, 27, 27), (5, 5, 96, 256), (256,),
                         scale=0.05))
        if li == "HWC":
            x = x.permute(0, 2, 3, 1).contiguous()
        kw = dict(stride=1, pad=2, in_layout=li, out_layout=lo)
        common.reset_launch_counts()
        got = conv_direct(x, w, b, **kw)
        assert common.launch_counts() == {"conv_direct": 1}
        assert got.dtype == dtype
        self._close(got, conv_direct_ref(x, w, b, **kw), 2e-2)
        assert torch.equal(got, conv_direct(x, w, b, **kw))

    @pytest.mark.parametrize("li,lo", [("CHW", "CHW"), ("HWC", "HWC"),
                                       ("CHW", "HWC")])
    def test_conv_im2col(self, cuda, li, lo):
        x, w, b = (torch.from_numpy(a).to(cuda) for a in
                   _data(5, (2, 16, 27, 27), (32, 16, 5, 5), (32,), scale=0.1))
        want = _conv64(x, w, b, 1, 2)
        xin = x.permute(0, 2, 3, 1).contiguous() if li == "HWC" else x
        got = conv_im2col(xin, w, b, stride=1, pad=2, in_layout=li,
                          out_layout=lo)
        if lo == "HWC":
            got = got.permute(0, 3, 1, 2)
        self._close(got, want, 1e-3)

    @pytest.mark.parametrize("m_", [2, 4])
    @pytest.mark.parametrize("li,lo", [("CHW", "CHW"), ("HWC", "HWC")])
    def test_conv_winograd(self, cuda, m_, li, lo):
        x, w, b = (torch.from_numpy(a).to(cuda) for a in
                   _data(6, (2, 24, 13, 13), (40, 24, 3, 3), (40,), scale=0.1))
        want = _conv64(x, w, b, 1, 1)
        u = prepare_kernel(w.cpu().numpy(), m_).to(cuda)
        xin = x.permute(0, 2, 3, 1).contiguous() if li == "HWC" else x
        got = conv_winograd(xin, u, b, m_=m_, k=3, pad=1, in_layout=li,
                            out_layout=lo)
        if lo == "HWC":
            got = got.permute(0, 3, 1, 2)
        self._close(got, want, 1e-3)

    @pytest.mark.parametrize("entry", ["chw_to_hwc", "hwc_to_chw",
                                       "chw_to_hwc8", "hwc8_to_chw"])
    def test_layout_transform(self, cuda, entry):
        x = torch.from_numpy(_data(7, (2, 96, 27, 27))[0]).to(cuda)
        hwc = x.permute(0, 2, 3, 1).contiguous()
        src = {"chw_to_hwc": x, "chw_to_hwc8": x, "hwc_to_chw": hwc,
               "hwc8_to_chw": hwc.reshape(2, 27, 27, 12, 8)}[entry]
        common.reset_launch_counts()
        got = getattr(lt_ops, entry)(src)
        assert common.launch_counts() == {f"layout_transform.{entry}": 1}
        assert torch.equal(got, getattr(lt_ref, f"{entry}_ref")(src))

    @pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16,
                                       torch.float32, torch.float64])
    @pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 8])
    def test_layout_transform_short_axis(self, cuda, c, dtype):
        """Short channel axes (the short-axis routes where ``route``
        picks them): bit for bit in 1-, 2-, 4- and 8-byte elements,
        ragged H*W, batch 2 and one image."""
        x = torch.from_numpy(np.abs(_data(17, (2, c, 13, 21))[0]) * 40).to(
            cuda, dtype)
        hwc = x.permute(0, 2, 3, 1).contiguous()
        cases = [("chw_to_hwc", x), ("hwc_to_chw", hwc)]
        if c % 8 == 0:
            cases += [("chw_to_hwc8", x),
                      ("hwc8_to_chw", hwc.reshape(2, 13, 21, c // 8, 8))]
        for entry, src in cases:
            for xx in (src, src[0]):
                common.reset_launch_counts()
                got = getattr(lt_ops, entry)(xx)
                assert common.launch_counts() == {
                    f"layout_transform.{entry}": 1}
                assert torch.equal(got, getattr(lt_ref, f"{entry}_ref")(xx))

    @pytest.mark.parametrize("dims,dtype,kw", [
        ((1, 4, 4, 256, 256, 64), torch.float32, {}),
        ((2, 4, 4, 300, 300, 128), torch.float32,
         dict(causal=True, window=40)),
        ((1, 4, 4, 200, 200, 64), torch.float32, dict(softcap=5.0)),
        ((2, 8, 2, 150, 150, 64), torch.float32,
         dict(layout="LHD", causal=True)),
        ((1, 2, 2, 64, 16, 64), torch.float32, dict(causal=True, window=8)),
        ((1, 4, 2, 130, 77, 256), torch.bfloat16, {}),
        ((1, 4, 4, 200, 200, 16), torch.float32, dict(causal=True)),
        ((2, 4, 2, 150, 150, 32), torch.float32, {}),
        ((1, 4, 4, 300, 300, 112), torch.float32, dict(softcap=5.0)),
        ((1, 4, 2, 130, 90, 320), torch.float32, dict(causal=True)),
        ((1, 4, 4, 256, 256, 7), torch.float32, dict(layout="LHD")),
        ((1, 4, 2, 256, 256, 64), torch.float16, dict(causal=True)),
        ((2, 4, 4, 100, 100, 112), torch.float16, dict(layout="LHD")),
    ])
    def test_flash_attention(self, cuda, dims, dtype, kw):
        b, hq, hkv, lq, lk, d = dims
        lhd = kw.get("layout") == "LHD"
        qs = (b, lq, hq, d) if lhd else (b, hq, lq, d)
        ks = (b, lk, hkv, d) if lhd else (b, hkv, lk, d)
        q, k, v = (torch.from_numpy(a).to(cuda, dtype)
                   for a in _data(8, qs, ks, ks))
        common.reset_launch_counts()
        got = flash_attention(q, k, v, **kw)
        assert common.launch_counts() == {"flash_attention": 1}
        want = flash_attention_ref(
            q, k, v, scale=d ** -0.5, seq_major=lhd,
            **{o: kw[o] for o in ("causal", "window", "softcap") if o in kw})
        assert got.dtype == dtype and bool(got.isfinite().all())
        self._close(got, want, 1e-5 if dtype == torch.float32 else 2e-2)
        if lk == 16:  # window 8 over keys 0..15: rows 23 and up see none
            assert bool((got[:, :, 23:] == 0).all())
        assert torch.equal(got, flash_attention(q, k, v, **kw))

    @pytest.mark.parametrize("d", [16, 64, 112, 320])
    def test_flash_attention_every_plan(self, cuda, d):
        """Every query tile and split count the C entry takes gives the
        plain version's output, the same bits on a repeated call."""
        q, k, v = (torch.from_numpy(a).to(cuda)
                   for a in _data(20, (1, 2, 200, d), (1, 2, 333, d),
                                  (1, 2, 333, d)))
        kw = dict(scale=d ** -0.5, causal=True)
        want = flash_attention_ref(q, k, v, **kw)
        for bq in (32,) if d > 256 else (32, 64):
            for s in range(1, 9):
                plan = make_plan(1, 2, 200, d, min(256, max(
                    32, 1 << (d - 1).bit_length())), bq, s)
                got = flash_attention_cuda(q, k, v, plan=plan, **kw)
                self._close(got, want, 1e-5)
                assert torch.equal(
                    got, flash_attention_cuda(q, k, v, plan=plan, **kw))

    def test_flash_attention_split_with_an_empty_rank(self, cuda):
        """Causal + window: the first query tile sees one KV tile, so
        ranks 1.. of its cluster get none (m = -1e30, l = 0) and must
        weigh nothing; rows no key reaches stay exactly 0."""
        q, k, v = (torch.from_numpy(a).to(cuda)
                   for a in _data(21, (1, 4, 512, 64), (1, 4, 512, 64),
                                  (1, 4, 512, 64)))
        kw = dict(scale=0.125, causal=True, window=48, lk_valid=300)
        plan = make_plan(1, 4, 512, 64, 64, 64, 4)
        got = flash_attention_cuda(q, k, v, plan=plan, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        self._close(got, want, 1e-5)
        # keys 0..299 with window 48: rows 347 and up see none
        assert bool((got[:, :, 347:] == 0).all())
        assert bool((got[:, :, :347].abs().sum(-1) > 0).all())
        assert torch.equal(got, flash_attention_cuda(q, k, v, plan=plan,
                                                     **kw))

    def test_flash_attention_bad_plan_is_refused(self, cuda):
        q = torch.zeros((1, 2, 64, 64), device=cuda)
        for plan in (make_plan(1, 2, 64, 64, 32, 64, 1),   # DP < D
                     make_plan(1, 2, 64, 64, 64, 48, 1),   # BQ 48
                     make_plan(1, 2, 64, 64, 64, 64, 9)):  # 9 splits
            with pytest.raises(RuntimeError, match="cudaError"):
                flash_attention_cuda(q, q, q, scale=1.0, plan=plan)
        assert attention_plan(q, q, q).dp == 64


# (what, M, K, N, batch of x, batch of y, lhs, out, bias + ReLU, dtype)
SPLIT_K_CASES = [
    ("K < BK", 70, 9, 33, 1, 1, "mk", "mn", False, torch.float32),
    ("K = 1", 64, 1, 129, 1, 1, "mk", "mn", True, torch.float32),
    ("K not a multiple of S*BK", 70, 1000, 33, 1, 1, "mk", "mn", True,
     torch.float32),
    ("odd N", 33, 777, 129, 1, 1, "mk", "nm", False, torch.float32),
    ("x broadcast over the batch", 96, 600, 45, 1, 3, "km", "mn", True,
     torch.float32),
    ("y broadcast over the batch", 40, 520, 77, 4, 1, "mk", "nm", True,
     torch.float32),
    ("km / nm", 129, 1500, 31, 1, 1, "km", "nm", True, torch.float32),
    ("bf16", 70, 1000, 45, 2, 2, "mk", "mn", True, torch.bfloat16),
    ("f16", 70, 1000, 45, 2, 2, "km", "nm", True, torch.float16),
]


@pytest.mark.gpu
class TestSplitK:
    """The cluster split-K GEMM and the implicit-GEMM conv on the card."""

    def _close(self, got, want, tol):
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max())

    @pytest.mark.parametrize(
        "what,m,k,n,bx,by,lhs,out,relu,dtype", SPLIT_K_CASES,
        ids=[c[0] for c in SPLIT_K_CASES])
    def test_matmul_split_k(self, cuda, what, m, k, n, bx, by, lhs, out,
                            relu, dtype):
        xs = (bx, k, m) if lhs == "km" else (bx, m, k)
        x, y, b = (torch.from_numpy(a).to(cuda, dtype) for a in
                   _data(9, xs, (by, k, n), (n,)))
        if bx == 1:
            x = x[0]
        elif by == 1:
            y = y.expand(bx, k, n)  # batch stride 0
        kw = dict(fuse_relu=relu, lhs_layout=lhs, out_layout=out)
        bias = b if relu else None
        if k >= 256:
            assert matmul_plan(x, y, lhs_layout=lhs).splits > 1
        got = matmul(x, y, bias, **kw)
        self._close(got, matmul_ref(x, y, bias, **kw),
                    1e-3 if dtype == torch.float32 else 2e-2)
        assert got.dtype == dtype
        assert torch.equal(got, matmul(x, y, bias, **kw))

    def test_relu_after_the_whole_sum(self, cuda):
        """Column 0 is -1 over the first split's K slice and +1 after it,
        column 1 the reverse: ReLU of the whole sum gives (k - 2 s, 0),
        ReLU per split would give (k - s, s)."""
        k = 1024
        x = torch.ones((8, k), device=cuda)
        y = torch.ones((k, 2), device=cuda)
        plan = matmul_plan(x, y)
        assert plan.splits > 1
        y[:plan.kslice, 0] = -1.0
        y[plan.kslice:, 1] = -1.0
        got = matmul(x, y, torch.zeros(2, device=cuda), fuse_relu=True)
        want = torch.tensor([[k - 2.0 * plan.kslice, 0.0]], device=cuda)
        assert torch.equal(got, want.expand(8, 2))

    @pytest.mark.parametrize("tile", [0, 1, 2, 3])
    @pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
    def test_every_plan(self, cuda, tile, splits):
        """Any tile and split count the C entry takes gives the product."""
        m, k, n = 150, 1100, 77
        x, y, b = (torch.from_numpy(a).to(cuda) for a in
                   _data(10, (1, m, k), (1, k, n), (n,)))
        kslice = -(-k // splits // 16) * 16
        plan = mm_kernel.GemmPlan(tile, splits, kslice, 1, 1, (0, 0, 0))
        c = torch.empty((1, m, n), device=cuda)
        mm_kernel.launch(plan, x, y, b, c, True)
        self._close(c, matmul_ref(x, y, b, fuse_relu=True), 1e-3)

    def test_bad_plan_is_refused(self, cuda):
        x, y = (torch.from_numpy(a).to(cuda) for a in
                _data(11, (1, 8, 64), (1, 64, 8)))
        c = torch.empty((1, 8, 8), device=cuda)
        for plan in (mm_kernel.GemmPlan(1, 9, 16, 1, 1, (0, 0, 0)),
                     mm_kernel.GemmPlan(1, 2, 16, 1, 1, (0, 0, 0)),
                     mm_kernel.GemmPlan(4, 1, 64, 1, 1, (0, 0, 0))):
            with pytest.raises(RuntimeError, match="cudaError"):
                mm_kernel.launch(plan, x, y, None, c, False)

    def test_libraries_keep_their_own_launch_state(self, cuda):
        """The GEMM and the Winograd GEMM build the same mainloop into two
        libraries; each must allow its own kernels' shared memory.  In a
        fresh process the Winograd GEMM launches every tile first, then
        the GEMM does, then a refused plan must not fail the next launch."""
        import os
        import subprocess
        import sys
        code = """
import torch
from repro_torch.kernels.matmul import kernel as mk
from repro_torch.kernels.matmul.plan import TILES, GemmPlan
from repro_torch.kernels.winograd_gemm import kernel as wk
x = torch.randn(2, 150, 300, device="cuda")
y = torch.randn(2, 300, 77, device="cuda")
want = torch.matmul(x, y)
def close(got):
    err = float((got - want).abs().max())
    assert err <= 1e-3 * float(want.abs().max()), err
plans = [GemmPlan(t, 2, 160, 1, 1, (0, 0, 0)) for t in range(len(TILES))]
for plan in plans:
    close(wk.winograd_bgemm_cuda(x, y, plan))
for plan in plans:
    c = torch.empty(2, 150, 77, device="cuda")
    mk.launch(plan, x, y, None, c, False)
    close(c)
try:
    mk.launch(GemmPlan(0, 9, 160, 1, 1, (0, 0, 0)), x, y, None, c, False)
except RuntimeError:
    pass
else:
    raise AssertionError("a plan of 9 splits was launched")
mk.launch(plans[0], x, y, None, c, False)
close(c)
torch.cuda.synchronize()
"""
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        subprocess.run([sys.executable, "-c", code], env=env, check=True,
                       timeout=300)

    def test_matmul_is_deterministic(self, cuda):
        """AlexNet conv4's im2col GEMM at batch 1, K split over a
        cluster."""
        w, p = (torch.from_numpy(a).to(cuda) for a in
                _data(12, (384, 3456), (1, 3456, 169)))
        assert plan_gemm(384, 169, 3456).splits > 1
        first = matmul(w, p)
        for _ in range(3):
            assert torch.equal(matmul(w, p), first)

    @pytest.mark.parametrize("li", ["CHW", "HWC"])
    @pytest.mark.parametrize("lo", ["CHW", "HWC"])
    def test_conv_direct_alexnet_conv2(self, cuda, li, lo):
        """AlexNet's conv2: 96 -> 256 channels, 5 x 5, pad 2, 27 x 27."""
        x, w, b = (torch.from_numpy(a).to(cuda) for a in
                   _data(13, (1, 96, 27, 27), (5, 5, 96, 256), (256,),
                         scale=0.05))
        if li == "HWC":
            x = x.permute(0, 2, 3, 1).contiguous()
        kw = dict(stride=1, pad=2, in_layout=li, out_layout=lo)
        common.reset_launch_counts()
        got = conv_direct(x, w, b, **kw)
        assert common.launch_counts() == {"conv_direct": 1}
        self._close(got, conv_direct_ref(x, w, b, **kw), 1e-3)
        assert torch.equal(got, conv_direct(x, w, b, **kw))

    def test_conv_direct_long_reduction(self, cuda):
        """K*K*C = 36864: every split is longer than the 4096-entry tap
        table, so the mainloop runs once per table chunk."""
        x, w, b = (torch.from_numpy(a).to(cuda) for a in
                   _data(14, (1, 10, 10, 4096), (3, 3, 4096, 8), (8,),
                         scale=0.05))
        assert conv_plan(1, 4096, 8, 3, 10, 10, False).kslice > 4096
        kw = dict(stride=1, pad=1)
        self._close(conv_direct(x, w, b, **kw),
                    conv_direct_ref(x, w, b, **kw), 1e-3)


# ----------------------------------------------------------------------
# compile_plan(jit=True): the forward captured as a CUDA graph, and the
# conv PlanServer serving such graphs
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def alexnet_plans():
    """AlexNet at full width under the H100 model with the kernels priced:
    its PBQP plan (the Winograd kernel on conv3-conv5) and weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    from repro_torch.convnets import alexnet
    from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
    from repro_torch.core.selection import select_pbqp
    net = alexnet(1.0)
    sel = select_pbqp(net, AnalyticCostModel(H100_SPEC, include_kernels=True))
    xs = np.random.default_rng(21).normal(
        size=(8,) + net.nodes["data"].out_shape).astype(np.float32)
    return sel, net.init_params(0), xs


@pytest.mark.gpu
class TestCapturedForward:
    @pytest.mark.parametrize("batch", [1, 8])
    def test_graph_equals_eager_and_counts_at_capture(self, cuda,
                                                      alexnet_plans, batch):
        from repro_torch.core.plan import compile_plan
        sel, params, xs = alexnet_plans
        x = xs[0] if batch == 1 else xs
        eager = compile_plan(sel, params, batch=batch, jit=False)
        graph = compile_plan(sel, params, batch=batch)
        assert graph.jit and graph.graph is None
        want = eager(x)
        once = expected_launches(sel)
        torch.cuda.synchronize()
        common.reset_launch_counts()
        got = graph(x)
        # the warm-up and the first replay launch; the capture only records
        assert common.launch_counts() == {k: 2 * v for k, v in once.items()}
        assert graph.capture_launches == once
        assert graph.capture_launches["winograd_gemm"] == 3
        for k in want:
            assert torch.equal(got[k], want[k])
        common.reset_launch_counts()
        again = graph(torch.from_numpy(x).to(cuda))
        assert common.launch_counts() == once  # each replay counts
        assert graph.graph.replays == 2
        for k in want:
            assert torch.equal(again[k], want[k])

    def test_replay_follows_the_input_and_outputs_are_not_aliased(
            self, cuda, alexnet_plans):
        from repro_torch.core.plan import compile_plan
        sel, params, xs = alexnet_plans
        eager = compile_plan(sel, params, jit=False)
        graph = compile_plan(sel, params)
        first = graph(xs[1])
        second = graph(xs[2])
        assert first["prob"].data_ptr() != second["prob"].data_ptr()
        assert torch.equal(first["prob"], eager(xs[1])["prob"])
        assert torch.equal(second["prob"], eager(xs[2])["prob"])
        assert not torch.equal(first["prob"], second["prob"])

    def test_a_capture_that_fails_raises(self, cuda, alexnet_plans):
        """No quiet fallback: a forward that cannot be captured (here, a
        host synchronisation inside it) raises, and nothing is kept."""
        from repro_torch.core.plan import compile_plan
        sel, params, xs = alexnet_plans
        graph = compile_plan(sel, params)
        walk = graph.fn

        def syncing(x, p):
            out = walk(x, p)
            float(out["prob"].sum())
            return out

        graph.fn = syncing
        with pytest.raises(RuntimeError):
            graph(xs[0])
        assert graph.graph is None
        graph.fn = walk
        graph(xs[0])
        with pytest.raises(ValueError, match="captured for input"):
            graph(xs[:2])  # (N, C, H, W) into a batch-1 graph

    def test_jit_has_no_effect_on_the_cpu(self, cuda, alexnet_plans):
        from repro_torch.core.plan import compile_plan
        sel, params, xs = alexnet_plans
        cnet = compile_plan(sel, params, device="cpu")
        cnet(xs[0])
        assert cnet.graph is None and cnet.capture_launches is None


def _tower_server(cuda, **kw):
    from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
    from repro_torch.serving import BucketPolicy, PlanServer, conv_stack
    return PlanServer(lambda s: conv_stack(s, depth=2, width=64),
                      AnalyticCostModel(H100_SPEC, include_kernels=True),
                      policy=BucketPolicy(min_hw=8, max_hw=64, max_n=8),
                      **kw)


@pytest.mark.gpu
class TestServingGraphs:
    def test_concurrent_prefetch_and_infer(self, cuda, alexnet_plans):
        """Two buckets captured on the worker pool while the caller serves
        a third: every answer holds the eager plan's bits."""
        from repro_torch.convnets import alexnet
        from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
        from repro_torch.core.plan import compile_plan
        from repro_torch.serving import BucketPolicy, PlanServer
        _, params, xs = alexnet_plans
        shape = xs.shape[1:]
        srv = PlanServer(lambda s: alexnet(1.0),
                         AnalyticCostModel(H100_SPEC, include_kernels=True),
                         policy=BucketPolicy(spatial="exact",
                                             channel="exact"))
        try:
            srv.infer(xs[0])
            f2, f4 = srv.prefetch(shape, n=2), srv.prefetch(shape, n=4)
            served = []
            while len(served) < 4 or not (f2.done() and f4.done()):
                served.append(srv.infer(xs[len(served) % 8]))
            f2.result(timeout=600)
            f4.result(timeout=600)
            eager = compile_plan(srv.plan_for(shape), params, jit=False)
            want = [eager(x)["prob"].cpu().numpy() for x in xs]
            for i, out in enumerate(served):
                assert np.array_equal(out["prob"], want[i % 8])
            for n in (2, 4):
                cnet = srv.compiled_for(shape, n)
                assert cnet.capture_launches == expected_launches(cnet.sel)
                e = compile_plan(cnet.sel, params, batch=n, jit=False)
                want_n = e(xs[:n])["prob"].cpu().numpy()
                got = srv.infer_batch(list(xs[:n]))
                for i in range(n):
                    assert np.array_equal(got[i]["prob"], want_n[i])
        finally:
            srv.close()

    @pytest.mark.parametrize("jit", [True, False])
    def test_a_kernel_that_raises_reaches_the_caller(self, cuda,
                                                     alexnet_plans,
                                                     monkeypatch, jit):
        """No fallback hides the card: a launcher's error is neither
        retried, demoted nor quarantined onto library routines.  With
        ``jit`` it fails the build (its first launch is the warm-up);
        without, it fails a request after the build's warm call."""
        from repro_torch.convnets import alexnet
        from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
        from repro_torch.kernels.winograd_gemm import ops
        from repro_torch.serving import BucketPolicy, PlanServer
        _, _, xs = alexnet_plans
        launch = ops.winograd_bgemm_cuda
        calls = []

        def failing(u, v):
            calls.append(1)
            if len(calls) > (0 if jit else 3):  # K3 on conv3-conv5
                raise RuntimeError("winograd_bgemm: launch failed")
            return launch(u, v)

        monkeypatch.setattr(ops, "winograd_bgemm_cuda", failing)
        srv = PlanServer(lambda s: alexnet(1.0),
                         AnalyticCostModel(H100_SPEC, include_kernels=True),
                         policy=BucketPolicy(spatial="exact",
                                             channel="exact"),
                         jit=jit, compile_retries=2)
        try:
            with pytest.raises(RuntimeError, match="launch failed"):
                srv.infer(xs[0])
            st = srv.stats()
            assert st["compiles"] == (0 if jit else 1)
            for k in ("compile_retries", "compile_fallbacks",
                      "kernel_failures", "quarantines"):
                assert st[k] == 0, (k, st)
            assert len(calls) == (1 if jit else 4)
        finally:
            srv.close()

    def test_diagnose_reraises_a_crash_on_the_card(self, cuda,
                                                   alexnet_plans):
        """A walk that raises on the card is the port's failure, not a
        kernel to blame (the CPU blames the conv, as the reference)."""
        from repro_torch.core.plan import compile_plan
        from repro_torch.reliability import diagnose_nonfinite
        sel, params, xs = alexnet_plans
        cnet = compile_plan(sel, params, jit=False)

        def broken(x, packed):
            raise RuntimeError("conv3: launch failed")

        cnet.makers["conv3"] = broken
        with pytest.raises(RuntimeError, match="launch failed"):
            diagnose_nonfinite(cnet, xs[0])

    def test_lru_eviction_releases_the_graph(self, cuda):
        import gc
        import weakref
        """Evicting an executable drops its graph (and the graph's private
        pool, which holds the 64 x 64 bucket's activations) and its packed
        weights: the 8 x 8 bucket that replaces it holds less memory."""
        srv = _tower_server(cuda, lru_capacity=1)
        rng = np.random.default_rng(22)
        a = rng.normal(size=(32, 64, 64)).astype(np.float32)
        b = rng.normal(size=(32, 8, 8)).astype(np.float32)
        try:
            srv.infer(a)
            cnet = srv.compiled_for(a.shape)
            assert cnet.graph is not None
            graph = weakref.ref(cnet.graph)
            weight = weakref.ref(next(iter(next(iter(
                cnet.params.values())).values())))
            del cnet
            gc.collect()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            srv.infer(b)  # evicts a's executable
            gc.collect()
            torch.cuda.synchronize()
            assert srv.stats()["exec_evictions"] == 1
            assert graph() is None and weight() is None
            assert torch.cuda.memory_allocated() < held
        finally:
            srv.close()


# ----------------------------------------------------------------------
# tuned variants: every launch space's configurations, pinned
# ----------------------------------------------------------------------
class _Spy:
    """The arguments of every C entry called inside the block."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = common.KernelLib.call

        def call(lib, entry, *args):
            self.calls.append((entry, args))
            return orig(lib, entry, *args)
        monkeypatch.setattr(common.KernelLib, "call", call)


#: where each C entry receives the launch a variant pins
_PIN_POS = {"repro_matmul_f32": (-6, -5), "repro_wino_bgemm": (-6, -5),
            "repro_conv_direct": (-5, -4), "repro_flash_attention": (-3, -2),
            "repro_transpose": (-2,)}
#: one scenario per registering space, K = 512 (every tile and split
#: count a legal plan), at batch 2
_TUNE_SCN = {"matmul": dict(c=512, h=14, w=14, stride=1, k=1, m=96, pad=0,
                            n=2),
             "conv_im2col": dict(c=512, h=13, w=13, stride=1, k=1, m=96,
                                 pad=0, n=2),
             "winograd_gemm": dict(c=512, h=13, w=13, stride=1, k=3, m=96,
                                   n=2),
             "conv_direct": dict(c=512, h=13, w=13, stride=1, k=1, m=96,
                                 pad=0, n=2)}


@pytest.mark.gpu
class TestTunedVariants:
    @pytest.mark.parametrize("kernel", sorted(_TUNE_SCN))
    def test_every_config_launches_its_pinned_plan(self, cuda, kernel,
                                                   monkeypatch):
        """Every configuration of the space: the C entry receives the
        pinned tile and split count, in every layout pair of the fused
        builder, and the output is the plain version's (on the CPU)
        within 1e-3 of its largest magnitude."""
        from repro_torch.autotune import spaces
        from repro_torch.core.layouts import LAYOUT_BY_NAME
        from repro_torch.core.primitives import to_tensor
        from repro_torch.core.scenario import Scenario
        space = spaces()[kernel]
        scn = Scenario(**_TUNE_SCN[kernel])
        rng = np.random.default_rng(31)
        x = rng.normal(size=scn.in_shape_nchw).astype(np.float32)
        w = (rng.normal(size=scn.weight_shape) * 0.1).astype(np.float32)
        b = rng.normal(size=(scn.m,)).astype(np.float32)
        spy = _Spy(monkeypatch)
        for cfg in space.configs():
            prim = space.make_primitive(cfg)
            assert prim.supports(scn), prim.name
            packed = prim.prepare(scn, w, b)
            cpu = {k: to_tensor(v) for k, v in packed.items()}
            dev = {k: v.to(cuda) for k, v in cpu.items()}
            for li in (prim.l_in,) + prim.fusable_in:
                xin = to_tensor(np.stack([LAYOUT_BY_NAME[li].to_memory(xi)
                                          for xi in x]))
                for lo in (prim.l_out,) + prim.fusable_out:
                    f = prim.make_fused(scn, l_in=li, l_out=lo)
                    spy.calls.clear()
                    got = f(xin.to(cuda), dev)
                    entry, args = spy.calls[-1]
                    assert tuple(args[i] for i in _PIN_POS[entry]) == \
                        (cfg["tile"], cfg["splits"]), (prim.name, li, lo)
                    want = f(xin, cpu)
                    err = float((got.cpu() - want).abs().max())
                    assert err <= 1e-3 * float(want.abs().max()), \
                        (prim.name, li, lo, err)

    def test_kernel_only_configs(self, cuda, monkeypatch):
        """Flash attention at every (BQ, S) and the transpose on every
        route it runs, as the tuner times them, against their plain
        versions (attention within 1e-5, the routes bit for bit)."""
        from repro_torch.autotune import spaces
        from repro_torch.core.scenario import Scenario
        sp = spaces()
        spy = _Spy(monkeypatch)
        scns = [Scenario(c=4, h=64, w=64, stride=1, k=3, m=8),
                Scenario(c=128, h=16, w=16, stride=1, k=3, m=8),
                Scenario(c=64, h=4, w=4, stride=1, k=3, m=8)]
        n = 0
        for kname in ("flash_attention", "layout_transform"):
            space = sp[kname]
            for cfg in space.configs():
                for scn in scns:
                    builder = space.benchmark(scn, cfg, device=cuda)
                    if builder is None:
                        continue
                    fn, args = builder()
                    spy.calls.clear()
                    got = fn(*args)
                    entry, cargs = spy.calls[-1]
                    pin = tuple(cfg.values())
                    assert tuple(cargs[i] for i in _PIN_POS[entry]) == pin
                    if kname == "flash_attention":
                        want = flash_attention_ref(*args, scale=64 ** -0.5)
                        err = float((got - want).abs().max())
                        assert err <= 1e-5 * float(want.abs().max())
                    else:
                        x, = args
                        want = x.permute(1, 2, 0).contiguous()
                        if x.shape[0] % 8 == 0:
                            want = want.unflatten(-1, (x.shape[0] // 8, 8))
                        assert torch.equal(got, want)
                    n += 1
        assert n == 16 * 3 + 5  # routes: tile x 3, short rows, columns

    def test_matmul_takes_a_plan(self, cuda):
        """``matmul_cuda(plan=)``: any legal pinned plan gives the
        product."""
        from repro_torch.kernels.matmul.plan import pin_gemm
        m, k, n = 150, 1024, 77
        x, y, b = (torch.from_numpy(a).to(cuda) for a in
                   _data(32, (m, k), (k, n), (n,)))
        want = matmul_ref(x, y, b, fuse_relu=True)
        for tile in range(4):
            for splits in (1, 2, 4, 8):
                plan = pin_gemm(m, n, k, tile=tile, splits=splits)
                got = mm_kernel.matmul_cuda(x, y, b, fuse_relu=True,
                                            plan=plan)
                err = float((got - want).abs().max())
                assert err <= 1e-3 * float(want.abs().max())

    def test_tune_measures_on_the_card(self, cuda, tmp_path):
        """A small real-mode tune: the profile is the card's, every item
        measured, the variants' kernel and the competing entries'
        launched."""
        from repro_torch.autotune import VariantCatalog, tune
        from repro_torch.calibrate import device_fingerprint, scenario_grid
        common.reset_launch_counts()
        res = tune(scenario_grid("tiny"), kernels=("matmul", "conv_im2col"),
                   max_per_kernel=4, reps=1, min_time=1e-4,
                   profile_path=tmp_path / "p.json")
        counts = common.launch_counts()
        assert res.catalog.measure == "real"
        assert res.profile.device == device_fingerprint(cuda)
        assert res.sweep["remaining"] == 0 and res.sweep["measured"] > 0
        assert all(v > 0 for v in res.profile.entries.values())
        assert counts.get("conv_im2col", 0) > 0 and \
            counts.get("winograd_gemm", 0) > 0
        res.catalog.save(tmp_path / "c.json")
        assert VariantCatalog.load(tmp_path / "c.json").content_hash() == \
            res.catalog.content_hash()


@pytest.mark.gpu
class TestInstrumentedNet:
    @pytest.mark.parametrize("batch", [1, 8])
    def test_outputs_are_the_eager_walks_bits(self, cuda, alexnet_plans,
                                              batch):
        """AlexNet's PBQP plan (K3 on conv3-conv5): each instrumented
        forward gives the eager walk's bits, times every node, and
        launches one forward's kernels."""
        from repro_torch.core.plan import compile_plan
        from repro_torch.obs.drift import InstrumentedNet
        sel, params, xs = alexnet_plans
        x = xs[0] if batch == 1 else xs
        cnet = compile_plan(sel, params, batch=batch, jit=False)
        inst = InstrumentedNet(cnet)
        want = cnet(x)
        torch.cuda.synchronize()
        common.reset_launch_counts()
        outs, tm = inst(x)
        assert common.launch_counts() == expected_launches(sel)
        for k in want:
            assert torch.equal(outs[k], want[k]), k
        assert {n.id for n in sel.net.conv_nodes()} <= set(tm["node"])
        assert set(tm["edge"]) == set(sel.conversions)
        assert all(t > 0 for t in tm["node"].values())

    def test_recalibration_loop_on_the_card(self, cuda):
        """The loop on a small tower from an empty profile of the card:
        it ends within its rounds, and the profile's hash moves if and
        only if it wrote an entry."""
        from repro_torch.calibrate import HardwareProfile
        from repro_torch.obs.drift import recalibration_loop
        from repro_torch.serving.towers import conv_stack
        net = conv_stack((3, 32, 32), depth=2, width=16)
        prof = HardwareProfile.new()
        h0 = prof.content_hash()
        x = np.random.default_rng(33).normal(size=(3, 32, 32)).astype(
            np.float32)
        res = recalibration_loop(
            net, net.init_params(0), x, prof, runs=2, max_rounds=4,
            allowed=("direct_lax_chw_chw_oihw", "wino2d_f2x3_chw",
                     "pallas_im2col_chw"))
        assert 1 <= len(res["rounds"]) <= 4
        assert (prof.content_hash() != h0) == (len(prof) > 0)
        det = res["detector"]
        assert det.runs == 2 and det.entries
