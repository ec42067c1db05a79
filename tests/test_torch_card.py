"""Each hand-written CUDA kernel against its plain PyTorch version, on
the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  This
file imports no JAX (the card's machine has none); run it there with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_card.py

Tolerances: f32 within 1e-3 of the largest plain magnitude (TF32 off;
the kernel and cuBLAS sum in different orders), bf16 within 2e-2 (one
bf16 rounding of the output).  The whole convolutions (the code around
the kernels: padding, patch gathers, Winograd transforms, crops) are
held to the same 1e-3 against an f64 ``F.conv2d``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import common
from repro_torch.kernels.conv_direct import conv_direct, conv_direct_ref
from repro_torch.kernels.conv_im2col import conv_im2col
from repro_torch.kernels.matmul import matmul, matmul_ref
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
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
