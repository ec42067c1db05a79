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

from repro_torch.kernels import all_launches, common
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
from repro_torch.kernels.winograd_transform import (
    PAIRS, input_transform_ref, output_transform_ref)
from repro_torch.kernels.winograd_transform import LIB as WT_LIB
from repro_torch.kernels.winograd_transform import ops as wt_ops


def _data(seed, *shapes, scale=None):
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if scale:
        out[1] = out[1] * np.float32(scale)
    return out


#: the tile route's cases: (shape, dtype, take ``x[1:]``); "one_tile" is
#: one 8 KB uint8 tile (128 x 64 elements) from CHW, two from
#: HWC (the HWC8 entries skip the C % 8 != 0 cases)
_LAYOUT_CASES = {
    "alexnet_ragged": ((2, 96, 27, 27), torch.float32, False),
    "uint8": ((2, 64, 20, 30), torch.uint8, False),
    "bf16": ((2, 64, 20, 30), torch.bfloat16, False),
    "f64": ((2, 64, 20, 30), torch.float64, False),
    "ragged_uint8": ((27, 13, 17), torch.uint8, False),
    "ragged_bf16": ((27, 13, 17), torch.bfloat16, False),
    "misaligned_uint8": ((3, 25, 7, 9), torch.uint8, True),
    "one_tile": ((128, 8, 8), torch.uint8, False),
    "vgg16_conv1_2": ((64, 256, 256), torch.float32, False),
}


def _layout_bits(shape, dtype, device):
    """Random bits of ``dtype`` (any pattern, NaNs too: compared as
    bytes), made from a seed."""
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    raw = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    return torch.from_numpy(raw).to(device).view(dtype).reshape(shape)


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

    @pytest.mark.parametrize("entry,case", [
        (e, c) for c, (shape, _, _) in _LAYOUT_CASES.items()
        for e in ("chw_to_hwc", "hwc_to_chw", "chw_to_hwc8", "hwc8_to_chw")
        if shape[-3] % 8 == 0 or "8" not in e])
    def test_layout_transform(self, cuda, entry, case):
        """The tile route bit for bit, one launch a call: AlexNet's
        ragged (96, 27, 27) at batch 2, every element size, planes whose
        R * e and S * e are not multiples of 16, a view whose base is not
        16-byte aligned, a plane of exactly one tile and VGG-16's
        (64, 256, 256) in f32."""
        shape, dtype, sliced = _LAYOUT_CASES[case]
        x = _layout_bits(shape, dtype, cuda)
        src = x if entry.startswith("chw") else \
            x.movedim(-3, -1).contiguous()
        if entry == "hwc8_to_chw":
            src = src.unflatten(-1, (src.shape[-1] // 8, 8))
        if sliced:
            src = src[1:]   # contiguous, its base one plane (1575 B) on
            assert src.is_contiguous() and src.data_ptr() % 16
        common.reset_launch_counts()
        got = getattr(lt_ops, entry)(src)
        assert common.launch_counts() == {f"layout_transform.{entry}": 1}
        want = getattr(lt_ref, f"{entry}_ref")(src)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))

    @pytest.mark.parametrize("entry,shape", [
        ("hwc_to_chw", (1449, 1449, 32)), ("hwc8_to_chw", (1449, 1449, 4, 8))])
    def test_layout_transform_long_hwc_plane(self, cuda, entry, shape):
        """H*W = 2,099,601 positions, more than 65535 tiles of 32 along R:
        planned on a 1-D grid, not refused (about 67 MB each)."""
        x = _layout_bits(shape, torch.uint8, cuda)
        common.reset_launch_counts()
        got = getattr(lt_ops, entry)(x)
        assert common.launch_counts() == {f"layout_transform.{entry}": 1}
        assert torch.equal(got, getattr(lt_ref, f"{entry}_ref")(x))

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


#: the Winograd transforms' planes, (C, M, H, W): VGG-16's five widths with
#: the net's channels, AlexNet's conv2, and ragged planes whose tiles
#: overhang
_WT_PLANES = {"vgg224": (64, 64, 224, 224), "vgg112": (128, 128, 112, 112),
              "vgg56": (256, 256, 56, 56), "vgg28": (512, 512, 28, 28),
              "vgg14": (512, 512, 14, 14), "alexnet_conv2": (96, 256, 27, 27),
              "ragged13x9": (5, 7, 13, 9), "ragged7x7": (3, 4, 7, 7)}


@pytest.mark.gpu
class TestWinogradTransform:
    """The input and output transforms against their plain einsums within
    1e-5 of the largest plain magnitude: the same f32 arithmetic with the
    same matrices, summed in another order."""

    @staticmethod
    def _hold(got, want):
        assert got.shape == want.shape and got.is_contiguous()
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err

    @pytest.mark.parametrize("mk", PAIRS, ids=lambda p: f"f{p[0]}x{p[1]}")
    @pytest.mark.parametrize("plane", sorted(_WT_PLANES))
    def test_against_the_plain_einsums(self, cuda, plane, mk):
        """Every (m, k), CHW and HWC in and out, batch 1 and 16, the bias
        on; one launch each."""
        m_, k = mk
        c, mo, h, w = _WT_PLANES[plane]
        pad = k // 2
        oh, ow = h + 2 * pad - k + 1, w + 2 * pad - k + 1
        t = -(-oh // m_) * -(-ow // m_)
        for n in (1, 16):
            x, q, b = (torch.from_numpy(a).to(cuda) for a in _data(
                n + m_ + k, (n, c, h, w), ((m_ + k - 1) ** 2, mo, n * t),
                (mo,)))
            want = input_transform_ref(x, m_, k, pad)
            for li in ("CHW", "HWC"):
                xv = x if li == "CHW" else \
                    x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
                common.reset_launch_counts()
                got = wt_ops.input_transform(xv, m_=m_, k=k, pad=pad)
                assert common.launch_counts() == {"winograd_transform": 1}
                self._hold(got, want)
            for lo in ("CHW", "HWC"):
                common.reset_launch_counts()
                got = wt_ops.output_transform(q, b, m_=m_, k=k, n=n, oh=oh,
                                              ow=ow, out_layout=lo)
                assert common.launch_counts() == {"winograd_transform": 1}
                self._hold(got, output_transform_ref(q, b, m_, k, n, oh, ow,
                                                     lo))

    @pytest.mark.parametrize("name", ["wino2d_f6x3_chw",
                                      "pallas_wino_f4x3_chw"])
    @pytest.mark.parametrize("batch", [1, 4])
    def test_primitive_against_conv2d(self, cuda, name, batch):
        """The whole convolution, CHW and HWC in and out, against
        ``F.conv2d`` with TF32 off (the fixture), within 1e-3 of its
        largest magnitude: two transforms and one GEMM a call."""
        from repro_torch.core.primitives import registry
        from repro_torch.core.scenario import Scenario
        prim = next(p for p in registry() if p.name == name)
        scn = Scenario(c=64, h=56, w=56, stride=1, k=3, m=96)
        x, w, b = _data(15 + batch, (batch, 64, 56, 56), (96, 64, 3, 3),
                        (96,), scale=0.05)
        packed = {k_: v.to(cuda) for k_, v in prim.prepare(scn, w, b).items()}
        xt = torch.from_numpy(x).to(cuda)
        want = F.conv2d(xt, torch.from_numpy(w).to(cuda),
                        torch.from_numpy(b).to(cuda), 1, 1)
        gemm = {"winograd_gemm": 1} if name.startswith("pallas") else {}
        for li in ("CHW", "HWC"):
            xin = xt if li == "CHW" else xt.permute(0, 2, 3, 1).contiguous()
            for lo in ("CHW", "HWC"):
                common.reset_launch_counts()
                got = prim.make_fused(scn, li, lo)(xin, packed)
                assert common.launch_counts() == {"winograd_transform": 2,
                                                  **gemm}
                if lo == "HWC":
                    got = got.permute(0, 3, 1, 2)
                err = float((got - want).abs().max())
                assert err <= 1e-3 * float(want.abs().max()), (li, lo, err)

    def test_vgg16_b1_graph_replay_counts(self, cuda):
        """VGG-16's batch-1 PBQP plan (the ``vgg16.b1`` cell's): 8 convs
        on ``wino2d_f6x3_chw`` and 4 on K3, so a replay counts 24
        transforms and 4 K3 GEMMs, and answers with the eager walk's
        bits."""
        from repro_torch.convnets import vgg
        from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
        from repro_torch.core.plan import compile_plan
        from repro_torch.core.selection import select_pbqp
        net = vgg("D", 1.0)
        sel = select_pbqp(net, AnalyticCostModel(H100_SPEC,
                                                 include_kernels=True))
        params = net.init_params(0)
        x = np.random.default_rng(22).normal(
            size=net.nodes["data"].out_shape).astype(np.float32)
        graph = compile_plan(sel, params)
        want = compile_plan(sel, params, jit=False)(x)
        graph(x)
        torch.cuda.synchronize()
        common.reset_launch_counts()
        got = graph(x)
        torch.cuda.synchronize()
        counts = common.launch_counts()
        assert counts == {"winograd_gemm": 4, "winograd_transform": 24}
        assert counts == all_launches(sel) == graph.capture_launches
        for k_ in want:
            assert torch.equal(got[k_], want[k_]), k_


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
        once = all_launches(sel)
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

    def test_no_garbage_collection_during_a_capture(self, cuda):
        """A collection on the capturing thread could free another
        executable's graph (a dropped executable in a reference cycle)
        mid-capture, and destroying a graph then invalidates the capture
        ("operation not permitted when stream is capturing"): the
        warm-up runs with the collector on, the capture with it off, and
        it is on again after, also after a capture that fails."""
        import gc

        from repro_torch.core.plan import CapturedForward
        seen = []

        def forward(x):
            seen.append(gc.isenabled())
            return {"y": x * 2}
        x = torch.ones(8, device=cuda)
        cf = CapturedForward(forward, x, cuda)
        assert seen == [True, False] and gc.isenabled()
        assert torch.equal(cf.run(x)["y"], x * 2)

        def syncing(x):
            out = forward(x)
            float(out["y"].sum())
            return out
        with pytest.raises(RuntimeError):
            CapturedForward(syncing, x, cuda)
        assert gc.isenabled()

    def test_a_graph_dropped_during_a_capture_outlives_it(self, cuda):
        """The fault the collector's pause repairs, made to happen: an
        executable whose only holder turns into cyclic garbage during
        another executable's capture.  Gen 0's threshold at 1 makes each
        allocation collect; a collection there would destroy the old
        graph mid-capture and invalidate the capture.  The capture
        succeeds, and the old executable is freed after it."""
        import gc
        import weakref

        from repro_torch.core.plan import CapturedForward
        x = torch.ones(8, device=cuda)
        keep = [CapturedForward(lambda x: {"y": x + 1}, x, cuda)]
        old = weakref.ref(keep[0])
        calls = []

        def forward(x):
            calls.append(1)
            if len(calls) == 2:     # the capture (1: the warm-up)
                box = [keep.pop()]
                box.append(box)
                del box
                junk = [[] for _ in range(100)]
                del junk
            return {"y": x * 2}
        threshold = gc.get_threshold()
        gc.set_threshold(1)
        try:
            cf = CapturedForward(forward, x, cuda)
        finally:
            gc.set_threshold(*threshold)
        gc.collect()
        assert len(calls) == 2 and old() is None
        assert torch.equal(cf.run(x)["y"], x * 2)

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
                assert cnet.capture_launches == all_launches(cnet.sel)
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


@pytest.fixture(scope="module")
def googlenet_b16():
    """GoogLeNet's batch-16 executable as the ``googlenet.offline-b16``
    cell serves it (exact buckets, the H100 model with the kernels
    priced), its server, 16 distinct batches and the eager walk's
    outputs of each, on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    from repro_torch.convnets import googlenet
    from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
    from repro_torch.serving import BucketPolicy, PlanServer
    srv = PlanServer(lambda s: googlenet(1.0),
                     AnalyticCostModel(H100_SPEC, include_kernels=True),
                     policy=BucketPolicy(spatial="exact", channel="exact",
                                         min_n=16, max_n=16))
    shape = (3, 224, 224)
    try:
        cnet = srv.compiled_for(shape, 16)
        rng = np.random.default_rng(31)
        xs = [rng.normal(size=(16,) + shape).astype(np.float32)
              for _ in range(16)]
        want = [{k: v.cpu() for k, v in
                 cnet.forward(torch.from_numpy(x).cuda()).items()}
                for x in xs]
        yield srv, cnet, xs, want
    finally:
        srv.close()


def _clients(n, calls, body):
    """``n`` threads each running ``body(thread, call)`` ``calls`` times;
    raises the first error any of them met."""
    import threading
    errors = []

    def client(t):
        try:
            for i in range(calls):
                body(t, i)
        except Exception as exc:  # raised below, on the test's thread
            errors.append(exc)
    threads = [threading.Thread(target=client, args=(t,)) for t in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    assert not any(th.is_alive() for th in threads)
    if errors:
        raise errors[0]


@pytest.mark.gpu
class TestStagedCopyIn:
    """A host input crosses to the card through the graph's two pinned
    slots on its copy stream, while another call's replay runs."""

    @pytest.mark.parametrize("via", ["executable", "server"])
    @pytest.mark.parametrize("threads", [2, 4])
    def test_every_call_gets_its_own_answer(self, cuda, googlenet_b16,
                                            threads, via):
        """Threads share one executable, each call with its own input
        array, neighbouring calls with different batches: every answer
        is the eager walk's bits of its own input, so no slot was
        refilled or read before the call before had done with it.
        Through the server each thread calls, and copies out, on its own
        stream."""
        srv, cnet, xs, want = googlenet_b16
        got = {}

        def call(t, i):
            j = (i * threads + t) % len(xs)
            if via == "server":
                outs = srv.infer_batch(list(xs[j]))
                out = {k: torch.from_numpy(np.stack([o[k] for o in outs]))
                       for k in outs[0]}
            else:
                out = {k: v.cpu() for k, v in cnet(xs[j].copy()).items()}
            got[t, i] = j, out
        _clients(threads, 200, call)
        assert len(got) == 200 * threads
        wrong = [key for key, (j, out) in got.items()
                 if out.keys() != want[j].keys()
                 or not all(torch.equal(out[k], want[j][k]) for k in out)]
        assert not wrong, wrong[:8]

    def test_counters(self, cuda, googlenet_b16):
        """One client finds the graph's stream idle on every call (its
        answer was on the host before it sent the next): each copy in is
        direct, none staged.  Two clients: a copy in that finds the
        other's replay running is staged, and some are issued under it."""
        srv, _, xs, _ = googlenet_b16
        before = srv.stats()
        for i in range(20):
            srv.infer_batch(list(xs[i % len(xs)]))
        one = srv.stats()
        for k in ("copy_in_staged", "copy_in_overlapped"):
            assert one[k] == before[k]
        _clients(2, 100, lambda t, i: srv.infer_batch(
            list(xs[(2 * i + t) % len(xs)])))
        two = srv.stats()
        staged = two["copy_in_staged"] - one["copy_in_staged"]
        overlapped = two["copy_in_overlapped"] - one["copy_in_overlapped"]
        assert 0 < overlapped <= staged <= 200

    def test_a_device_input_is_copied_directly(self, cuda, googlenet_b16):
        """A CUDA tensor skips the slots (and the counters): it is copied
        into the static input on the graph's stream, with the same bits
        as the staged copy of the same batch, sent while its replay
        runs (held back behind a spin on the caller's stream, which the
        replay waits for)."""
        srv, cnet, xs, want = googlenet_b16
        before = srv.stats()["copy_in_staged"]
        x = torch.from_numpy(xs[3]).to(cuda)
        torch.cuda._sleep(200_000_000)
        direct = cnet(x)
        staged = cnet(xs[3])
        assert srv.stats()["copy_in_staged"] == before + 1
        for k in want[3]:
            assert torch.equal(direct[k].cpu(), want[3][k])
            assert torch.equal(staged[k].cpu(), want[3][k])


#: the spans under ``execute`` on the graph path, in order
_GRAPH_STEPS = ["copy_in", "replay", "device_wait", "copy_out", "guard"]


@pytest.mark.gpu
class TestServingSpans:
    def test_graph_path_spans_and_profiler_ranges(self, cuda,
                                                  alexnet_plans):
        """A served graph's ``execute`` splits into copy in, replay, the
        wait for the stream, copy out and the non-finite guard, and
        they hold most of it; under ``torch.profiler`` each span is a
        host range of its name, and none is a device event (a device
        annotation would widen the busy time read from the trace)."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.convnets import alexnet
        from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
        from repro_torch.obs.trace import configure
        from repro_torch.serving import BucketPolicy, PlanServer
        _, _, xs = alexnet_plans
        srv = PlanServer(lambda s: alexnet(1.0),
                         AnalyticCostModel(H100_SPEC, include_kernels=True),
                         policy=BucketPolicy(spatial="exact",
                                             channel="exact"))
        recs = []
        try:
            srv.infer(xs[0])  # the capture
            configure(recs, enabled=True)
            srv.infer(xs[1])
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                srv.infer(xs[2])
                torch.cuda.synchronize()
        finally:
            configure(None, enabled=False)
            srv.close()
        roots = [r for r in recs if r["name"] == "infer"]
        assert len(roots) == 2
        for root in roots:
            mine = [r for r in recs if r["trace"] == root["trace"]]
            ex = next(r for r in mine if r["name"] == "execute")
            kids = sorted((r for r in mine if r["parent"] == ex["span"]),
                          key=lambda r: r["t0"])
            assert [r["name"] for r in kids] == _GRAPH_STEPS
            assert all(r["t0"] + r["dur_s"] <= ex["t0"] + ex["dur_s"]
                       for r in kids)
            # what no step names (stream bookkeeping) is the lesser part
            assert sum(r["dur_s"] for r in kids) > 0.5 * ex["dur_s"]
        events = prof.profiler.kineto_results.events()
        host = {e.name() for e in events
                if e.device_type() == torch.autograd.DeviceType.CPU}
        dev = {e.name() for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA}
        names = {"infer", "lookup", "pad", "execute", "crop", *_GRAPH_STEPS}
        assert names <= host
        assert not names & dev


# ----------------------------------------------------------------------
# tuned variants: every launch space's configurations, pinned
# ----------------------------------------------------------------------
class _Spy:
    """The arguments of every C entry called inside the block, but the
    Winograd transforms' (around a pinned GEMM, pinning nothing)."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = common.KernelLib.call

        def call(lib, entry, *args):
            if lib is not WT_LIB:
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
        assert common.launch_counts() == all_launches(sel)
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


# ----------------------------------------------------------------------
# the LM serving path: K6 in every prefill, ServeLoop, ContinuousScheduler
# ----------------------------------------------------------------------
def _lm_params(cfg, seed=0):
    from repro_torch.models import init_params
    return init_params(cfg, seed, torch.float32)


@pytest.mark.gpu
class TestLMServing:
    @pytest.mark.parametrize("t", [1, 7, 1024, 1500])
    @pytest.mark.parametrize("hq,hkv", [(32, 4), (4, 2)])
    def test_flash_attention_at_prefill_shapes(self, cuda, hq, hkv, t):
        """K6 as the LM's prefill calls it: sequence-major q (1, T, Hq,
        64) over k, v (1, T, Hkv, 64), causal, GQA 8 (TinyLlama) and 2
        (its scaled-down config), a one-token prompt included."""
        q, k, v = (torch.from_numpy(a).to(cuda) for a in _data(
            19, (1, t, hq, 64), (1, t, hkv, 64), (1, t, hkv, 64)))
        kw = dict(scale=0.125, causal=True)
        common.reset_launch_counts()
        got = flash_attention(q, k, v, layout="LHD", **kw)
        assert common.launch_counts() == {"flash_attention": 1}
        want = flash_attention_ref(q, k, v, seq_major=True, **kw)
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())

    def test_full_width_layer_prefill_flash_against_plain(self, cuda):
        """One TinyLlama-1.1B layer at full width: the prefill's logits
        with the flash kernel within 1e-3 of the plain path's largest
        magnitude, and the same cache; one K6 launch per layer."""
        from dataclasses import replace

        from repro_torch.configs import get_config
        from repro_torch.models import ModelRuntime, ShardingPlan, prefill
        cfg = replace(get_config("tinyllama-1.1b"), n_layers=1)
        params = _lm_params(cfg)
        tok = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab, size=(1, 300))).to(cuda)
        lx, cx = prefill(cfg, params, {"tokens": tok}, ShardingPlan(),
                         ModelRuntime(), max_seq=320)
        common.reset_launch_counts()
        lf, cf = prefill(cfg, params, {"tokens": tok}, ShardingPlan(),
                         ModelRuntime(attn_impl="flash"), max_seq=320)
        assert common.launch_counts() == {"flash_attention": 1}
        assert float((lf - lx).abs().max()) <= \
            1e-3 * float(lx.abs().max())
        assert torch.equal(cf["layer0"]["k"], cx["layer0"]["k"])
        assert torch.equal(cf["layer0"]["v"], cx["layer0"]["v"])

    def test_serve_loop_matches_offline_decode(self, cuda):
        """The batched per-slot decode against one-request prefill +
        decode_step on the card: 5 requests over 2 slots, one reaching
        max_seq - 1."""
        from repro_torch.configs import get_config
        from repro_torch.models import (ModelRuntime, ShardingPlan,
                                        decode_step, prefill)
        from repro_torch.runtime import Request, ServeLoop
        cfg = get_config("tinyllama-1.1b").scaled_down(n_layers=2)
        params = _lm_params(cfg)
        rt = ModelRuntime(attn_impl="flash")
        rng = np.random.default_rng(7)
        lens = (5, 9, 31, 3, 17)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n)
                        .astype(np.int32), max_new_tokens=6)
                for i, n in enumerate(lens)]
        loop = ServeLoop(cfg, params, max_batch=2, max_seq=32, rt=rt)
        loop.run(reqs)
        assert all(r.done for r in reqs)
        # the 31-token prompt stops at max_seq - 1 after one tick; its
        # slot then idles at position max_seq
        assert len(reqs[2].tokens) == 2
        for r in reqs:
            tok = torch.from_numpy(r.prompt.astype(np.int64))[None].to(cuda)
            lg, cache = prefill(cfg, params, {"tokens": tok},
                                ShardingPlan(), rt, max_seq=32)
            want, pos = [int(lg[0, -1].argmax())], len(r.prompt)
            while len(want) < len(r.tokens):
                lg, cache = decode_step(cfg, params, cache,
                                        torch.tensor([[want[-1]]],
                                                     device=cuda),
                                        pos, ShardingPlan(), rt)
                want.append(int(lg[0, 0].argmax()))
                pos += 1
            assert r.tokens == want, r.rid

    def test_scheduler_feeds_the_loop_from_captured_graphs(self, cuda):
        """Images through the loop's ContinuousScheduler to a PlanServer
        serving captured graphs (captured on its workers while the main
        thread prefills): the same tokens as behind an eager server, and
        every bucket's executable a graph."""
        from repro_torch.configs import get_config
        from repro_torch.core.costs import AnalyticCostModel
        from repro_torch.models import ModelRuntime
        from repro_torch.runtime import Request, ServeLoop
        from repro_torch.serving import BucketPolicy, PlanServer, conv_tower
        cfg = get_config("tinyllama-1.1b").scaled_down(n_layers=2)
        params = _lm_params(cfg)
        rng = np.random.default_rng(8)
        imgs = [rng.normal(size=(3, hw, hw)).astype(np.float32)
                for hw in (12, 20, 33, 40, 14, 27)]
        prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
                   for n in rng.integers(4, 24, size=len(imgs))]
        runs = {}
        for jit in (True, False):
            srv = PlanServer(lambda s: conv_tower(s, depth=2, width=8),
                             AnalyticCostModel(), jit=jit,
                             policy=BucketPolicy(min_hw=8, max_hw=128))
            loop = ServeLoop(cfg, params, max_batch=4, max_seq=64,
                             rt=ModelRuntime(attn_impl="flash"),
                             plan_server=srv)
            reqs = [Request(rid=i, prompt=p, max_new_tokens=5, pixels=x)
                    for i, (p, x) in enumerate(zip(prompts, imgs))]
            try:
                loop.run(reqs)
                if jit:
                    for x in imgs:
                        assert srv.compiled_for(x.shape).graph is not None
            finally:
                loop.close()
                srv.close()
            runs[jit] = [(list(r.prompt), r.tokens) for r in reqs]
        assert runs[True] == runs[False]


@pytest.mark.gpu
class TestFamilies:
    @pytest.mark.parametrize("t,hq,hkv,d,causal", [
        (1500, 20, 20, 64, False),    # whisper-large-v3's encoder
        (3008, 56, 8, 128, True),     # llava-next-34b: 2880 patches + 128
        (1500, 32, 8, 128, True)])    # jamba-v0.1's attention layer
    def test_flash_attention_at_family_shapes(self, cuda, t, hq, hkv, d,
                                              causal):
        """K6 as the families' prefills call it, sequence-major, within
        1e-5 of the plain version's largest magnitude: non-causal MHA at
        L = 1500 (not a multiple of any query tile), GQA 7 and GQA 4 at
        head dim 128."""
        q, k, v = (torch.from_numpy(a).to(cuda) for a in _data(
            23, (1, t, hq, d), (1, t, hkv, d), (1, t, hkv, d)))
        kw = dict(scale=d ** -0.5, causal=causal)
        common.reset_launch_counts()
        got = flash_attention(q, k, v, layout="LHD", **kw)
        assert common.launch_counts() == {"flash_attention": 1}
        want = flash_attention_ref(q, k, v, seq_major=True, **kw)
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())

    def test_jamba_serve_loop_matches_offline_decode(self, cuda):
        """The hybrid family (attention, Mamba and MoE layers) served on
        the card: 5 requests over 2 slots, every token the argmax of a
        one-request prefill + decode_step; K6 once per prefill."""
        from repro_torch.configs import get_config
        from repro_torch.models import (ModelRuntime, ShardingPlan,
                                        decode_step, prefill)
        from repro_torch.runtime import Request, ServeLoop
        cfg = get_config("jamba-v0.1-52b").scaled_down()
        params = _lm_params(cfg)
        rt = ModelRuntime(attn_impl="flash")
        rng = np.random.default_rng(17)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n)
                        .astype(np.int32), max_new_tokens=6)
                for i, n in enumerate((5, 9, 2, 17, 12))]
        loop = ServeLoop(cfg, params, max_batch=2, max_seq=32, rt=rt)
        common.reset_launch_counts()
        loop.run(reqs)
        # two attention layers (one per superblock) per prefill
        assert common.launch_counts() == {"flash_attention": 2 * len(reqs)}
        for r in reqs:
            tok = torch.from_numpy(r.prompt.astype(np.int64))[None].to(cuda)
            lg, cache = prefill(cfg, params, {"tokens": tok},
                                ShardingPlan(), rt, max_seq=32)
            want, pos = [int(lg[0, -1].argmax())], len(r.prompt)
            while len(want) < len(r.tokens):
                lg, cache = decode_step(cfg, params, cache,
                                        torch.tensor([[want[-1]]],
                                                     device=cuda),
                                        pos, ShardingPlan(), rt)
                want.append(int(lg[0, 0].argmax()))
                pos += 1
            assert r.tokens == want, r.rid

    def test_mamba_decode_carries_its_state(self, cuda):
        """Prefill and four decode steps of the SSM family on the card
        against the same on the CPU (the plain path, which the CPU tests
        hold to the reference): every step's logits and the ``ssm`` and
        ``conv`` states, each of which must move every step."""
        from repro_torch.configs import get_config
        from repro_torch.models import (ShardingPlan, decode_step,
                                        init_params, prefill)
        cfg = get_config("mamba2-2.7b").scaled_down()
        cpu = init_params(cfg, 0, torch.float32, "cpu")

        def to(tree, dev):
            if isinstance(tree, dict):
                return {k: to(v, dev) for k, v in tree.items()}
            return tree.to(dev, copy=True)
        card = to(cpu, cuda)
        tok = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 12))
        runs = {}
        for dev, params in (("cpu", cpu), (cuda, card)):
            t = torch.from_numpy(tok).to(dev)
            lg, cache = prefill(cfg, params, {"tokens": t}, ShardingPlan(),
                                max_seq=20)
            out = [lg.cpu()]
            states = []
            for step in range(4):
                before = to(cache, "cpu")
                lg, cache = decode_step(cfg, params, cache, t[:, step:step + 1],
                                        12 + step, ShardingPlan())
                out.append(lg.cpu())
                for lk, leaf in cache.items():
                    for name in ("ssm", "conv"):
                        assert not torch.equal(leaf[name].cpu(),
                                               before[lk][name])
                states.append(to(cache, "cpu"))
            runs[str(dev)] = (out, states)
        (a, sa), (b, sb) = runs.values()
        for x, y in zip(a, b):
            assert float((x - y).abs().max()) <= 1e-3 * float(x.abs().max())
        for ca, cb in zip(sa, sb):
            for lk in ca:
                for name in ca[lk]:
                    x, y = ca[lk][name], cb[lk][name]
                    assert float((x - y).abs().max()) <= \
                        1e-3 * float(x.abs().max())


# ----------------------------------------------------------------------
# training: the loop, the optimizer and the checkpointer on the card
# ----------------------------------------------------------------------
@pytest.mark.gpu
class TestTraining:
    CFG_KW = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)

    def _cfg(self):
        from repro_torch.configs import get_config
        return get_config("tinyllama-1.1b").scaled_down(**self.CFG_KW)

    def test_flash_attention_refuses_autograd_on_the_card(self, cuda):
        """K6 has no backward: ``loss_fn`` with ``attn_impl="flash"``
        under grad raises before the kernel launches; under
        ``no_grad`` it launches once per layer."""
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.data import make_batch
        from repro_torch.models import ModelRuntime, ShardingPlan, loss_fn
        cfg = self._cfg()
        params = _lm_params(cfg)
        batch = make_batch(cfg, ShapeConfig("t", 32, 2, "train"), 0,
                           dtype=torch.float32)
        leaves = {k: v for k, v in params.items()}
        leaves["embed"] = params["embed"].detach().requires_grad_()
        common.reset_launch_counts()
        with pytest.raises(NotImplementedError, match="no backward"):
            loss_fn(cfg, leaves, batch, ShardingPlan(),
                    ModelRuntime(attn_impl="flash"))
        assert common.launch_counts() == {}
        with torch.no_grad():
            got = loss_fn(cfg, leaves, batch, ShardingPlan(),
                          ModelRuntime(attn_impl="flash"))
            want = loss_fn(cfg, leaves, batch, ShardingPlan(),
                           ModelRuntime())
        assert common.launch_counts() == {"flash_attention": cfg.n_layers}
        assert abs(float(got) - float(want)) <= 1e-5 * float(want)

    def test_training_on_the_card_follows_the_cpu(self, cuda, tmp_path):
        """From one step-0 state: the loss within 1e-5 relative on the
        card against the CPU; each gradient leaf of the card's within
        max(1e-4, twice the CPU's worst leaf) of a float64 evaluation on
        the CPU, per leaf of its largest (the rule of
        ``test_torch_train.py``: these gradients are ill-conditioned),
        which the next batch's gradient, a wrong one, fails; AdamW's
        update of the same gradients within 1e-6.  Then 3 steps of
        ``train()`` on each from one step-0 checkpoint: step 0's loss
        within 1e-5, the next within 1e-3 relative (AdamW's sign-like
        first step parts the runs), the state restored onto the card."""
        import shutil

        from repro_torch.checkpoint import Checkpointer
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.data import make_batch
        from repro_torch.models import ModelRuntime, ShardingPlan, init_params
        from repro_torch.optim import adamw, warmup_cosine
        from repro_torch.runtime import TrainLoopConfig, train
        from repro_torch.runtime.train_loop import loss_and_grads
        from repro_torch.tree import leaves, unflatten

        def dists(got, want):
            return [float((x.cpu().double() - y).abs().max()
                          / y.abs().max())
                    for x, y in zip(leaves(got), leaves(want))]

        def dist(got, want):
            return max(dists(got, want))

        def to_card(tree):
            return unflatten(tree, [t.to(cuda) for t in leaves(tree)])
        cfg = self._cfg()
        opt = adamw(warmup_cosine(1e-3, 2, 10))
        params = init_params(cfg, 0, torch.float32, "cpu")
        state = opt.init(params)
        shape = ShapeConfig("t", 32, 4, "train")

        def grads(p, step, dev):
            return loss_and_grads(cfg, ShardingPlan(), ModelRuntime(), p,
                                  make_batch(cfg, shape, step,
                                             dtype=torch.float32,
                                             device=dev))
        lc, gc_ = grads(params, 0, "cpu")
        lg, gg = grads(to_card(params), 0, cuda)
        assert abs(float(lc) - float(lg)) <= 1e-5 * abs(float(lc))
        # float64 on the CPU: the model's f32 casts made f64 for the call
        real = torch.Tensor.float
        torch.Tensor.float = lambda self, *a, **kw: self.double()
        try:
            _, g64 = grads(unflatten(params, [t.double() for t in
                                              leaves(params)]), 0, "cpu")
        finally:
            torch.Tensor.float = real
        g64 = unflatten(g64, [t.double() for t in leaves(g64)])
        gate = max(1e-4, 2 * dist(gc_, g64))
        assert dist(gg, g64) <= gate
        assert dist(grads(to_card(params), 1, cuda)[1], g64) > gate
        p1, s1 = opt.update(to_card(gc_), to_card(state), to_card(params))
        assert s1["count"].device.type == "cuda"
        p1c, s1c = opt.update(gc_, state, params)
        assert dist((p1, s1["m"], s1["v"]), (p1c, s1c["m"], s1c["v"])) \
            <= 1e-6
        assert int(s1["count"]) == int(s1c["count"]) == 1
        Checkpointer(tmp_path / "cpu").save(0, (params, state))
        shutil.copytree(tmp_path / "cpu", tmp_path / "cuda")
        runs = {}
        for dev in ("cpu", "cuda"):
            m = []
            st = train(cfg, shape, opt, loop=TrainLoopConfig(
                total_steps=3, ckpt_dir=str(tmp_path / dev), log_every=0),
                metrics_out=m, device=dev)
            runs[dev] = [x["loss"] for x in m]
        assert st.opt_state["count"].device.type == "cuda"
        lc, lg = runs["cpu"], runs["cuda"]
        assert len(lc) == len(lg) == 3
        assert abs(lc[0] - lg[0]) <= 1e-5 * abs(lc[0])
        for a, b in zip(lc[1:], lg[1:]):
            assert abs(a - b) <= 1e-3 * abs(a)

    def test_checkpoint_round_trip_on_the_card(self, cuda, tmp_path):
        from repro_torch.checkpoint import Checkpointer
        tree = ({"w": torch.randn(33, 7, device=cuda),
                 "h": torch.randn(5, device=cuda).to(torch.bfloat16)},
                {"count": torch.tensor(4, dtype=torch.int32, device=cuda)})
        ck = Checkpointer(tmp_path)
        ck.save(2, tree)
        like = _to_zeros(tree)
        step, back, _ = ck.restore(like)
        assert step == 2
        assert back[0]["w"].device.type == "cuda"
        assert torch.equal(back[0]["w"], tree[0]["w"])
        assert back[0]["h"].dtype == torch.bfloat16
        assert torch.equal(back[0]["h"], tree[0]["h"])
        assert int(back[1]["count"]) == 4


def _to_zeros(tree):
    if isinstance(tree, dict):
        return {k: _to_zeros(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_zeros(v) for v in tree)
    return torch.zeros_like(tree)


@pytest.mark.gpu
class TestMesh:
    """The mesh executables on the card: worlds of ranks sharing
    ``cuda:0`` over gloo (``run_spmd``; NCCL refuses two ranks on one
    device), the cases of ``tests/_torch_mesh_cases.py``, held as
    ``chip_smoke.py``'s phase 14 holds them."""

    def test_gloo_collectives_on_cuda_tensors(self, cuda):
        import _torch_mesh_cases as C
        from repro_torch.launch.mesh import default_backend, run_spmd
        assert default_backend("cuda", 4) == "gloo"
        ranks = run_spmd(C.collectives, 4, args=("cuda",), device="cuda",
                         timeout_s=120.0)
        for got in ranks:
            assert got["devices"] == ["cuda"]
            assert "all_to_all_single" in got["names"]

    @pytest.mark.parametrize("world,cases", [
        (2, ("conv_stack_data2", "conv_tower_data2")),
        (4, ("bottleneck_data2_model2",)),
        (4, ("uniform_stack_stage4",))])
    def test_four_modes_match_one_device(self, cuda, world, cases):
        """Each mode as the CPU tests give it; every rank's outputs (every
        conv and sink) within 1e-3 of the largest magnitude of the same
        selection without a mesh, on the card and on the CPU; the path's
        launches as expected; nothing captured (``jit=True`` is accepted
        on a mesh and has no effect)."""
        import _torch_mesh_cases as C
        from repro_torch.launch.mesh import run_spmd
        ranks = run_spmd(C.plan_cases, world,
                         args=({c: C.CARD_CASES[c] for c in cases}, "cuda"),
                         device="cuda", timeout_s=120.0)
        for got in ranks:
            for case in cases:
                C.check_card_case(case, got[case], 1e-3)

    def test_mesh_server_matches_plain(self, cuda, tmp_path):
        import _torch_mesh_cases as C
        from repro_torch.launch.mesh import run_spmd
        ranks = run_spmd(C.serve_cases, 2,
                         args=(str(tmp_path), "cuda", ((2,), ("data",))),
                         device="cuda", timeout_s=120.0)
        for r in ranks:
            C.check_serve(r, 1e-3)


@pytest.mark.gpu
class TestMeshLM:
    """The LM on a mesh on the card (slice G2): ranks sharing ``cuda:0``
    over gloo, the cases and gates of ``tests/_torch_mesh_lm_cases.py``,
    which ``chip_smoke.py``'s phase 15 runs at full depth: (a)
    TinyLlama at full width and 2 layers on {data: 2, model: 2} with K6
    on each rank's heads against the single-device run, with (d) the
    compressed all-reduce in the same world; (c) a Jamba-v0.1 MoE layer
    at full width through the all-to-all schedule on {model: 2}."""

    def test_tinyllama_mesh_matches_one_device(self, cuda, tmp_path):
        import _torch_mesh_lm_cases as C
        from repro_torch.launch.mesh import run_spmd
        C.card_single(2, 4, str(tmp_path), "cuda")
        ranks = run_spmd(C.card_lm_world, 4,
                         args=(2, 4, str(tmp_path), "cuda"), device="cuda",
                         timeout_s=300.0)
        C.check_card_lm(ranks, 2, "cuda", C.REL)
        C.check_card_compress(ranks)

    def test_alltoall_moe_matches_one_device(self, cuda, tmp_path):
        import _torch_mesh_lm_cases as C
        from repro_torch.launch.mesh import run_spmd
        res = run_spmd(C.card_moe_world, 2, args=(str(tmp_path), "cuda"),
                       device="cuda", timeout_s=300.0)
        C.check_card_moe(res, 1e-5)
