"""The port's kernel wrappers against the reference's Pallas ops.

On the CPU every wrapper runs its plain PyTorch version; the reference's
Pallas kernels run in interpret mode, as tests/test_kernels.py runs them.
Inputs are made with numpy from a seed and fed to both packages, over
the shapes and layouts of tests/test_kernels.py.

Tolerances: f32 at rtol = atol = 1e-4 — both sides accumulate in f32,
but XLA's dot and PyTorch's matmul sum in different orders (and the
reference pads K to block multiples), which moves the last few bits of
sums over up to 257 terms; bf16 and f16 at 2e-2 — the output is rounded
to bf16 (8 mantissa bits) or f16 (11), so one rounding step of a value
near 4 is ~2e-2 in bf16.  Every kernel takes f32, bf16 and f16, as the
reference's do: inputs in the dtype, f32 accumulation, the output in the
dtype.

The CUDA kernels themselves are compared with their plain versions on
the card by tests/test_torch_card.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import conv_direct as r_direct
from repro.kernels import conv_im2col as r_im2col
from repro.kernels import matmul as r_matmul
from repro.kernels import winograd_gemm as r_wino
from repro_torch.kernels import common
from repro_torch.kernels.conv_direct import conv_direct, conv_direct_ref
from repro_torch.kernels.conv_im2col import conv_im2col, conv_im2col_ref
from repro_torch.kernels.matmul import matmul, matmul_ref
from repro_torch.kernels.winograd_gemm import (bgemm_ref, conv_winograd,
                                               prepare_kernel,
                                               winograd_bgemm)

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    PyTorch's default of one thread per core would oversubscribe the
    machine under the timing-sensitive tests of the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed, *shapes, scale=None):
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if scale:
        out[1] = out[1] * np.float32(scale)
    return out


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


class TestMatmul:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    def test_shapes_dtypes(self, dtype):
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        for m, k, n in [(128, 128, 128), (256, 384, 128), (64, 96, 32),
                        (17, 33, 9), (1, 128, 128), (130, 257, 129)]:
            x, y = _data(m * k * n, (m, k), (k, n))
            want = r_matmul.matmul(jnp.asarray(x, jd), jnp.asarray(y, jd))
            got = matmul(torch.from_numpy(x).to(td),
                         torch.from_numpy(y).to(td))
            assert got.dtype == td
            np.testing.assert_allclose(
                _np(got), _np(want), err_msg=f"{m}x{k}x{n}",
                **(F32 if dtype == "float32" else BF16))

    def test_layouts_bias_relu(self):
        x, y, b = _data(7, (64, 48), (48, 40), (40,))
        for lhs in ("mk", "km"):
            xs = x.T.copy() if lhs == "km" else x
            for out in ("mn", "nm"):
                want = r_matmul.matmul(jnp.asarray(xs), jnp.asarray(y),
                                       jnp.asarray(b), fuse_relu=True,
                                       lhs_layout=lhs, out_layout=out)
                got = matmul(torch.from_numpy(xs), torch.from_numpy(y),
                             torch.from_numpy(b), fuse_relu=True,
                             lhs_layout=lhs, out_layout=out)
                np.testing.assert_allclose(_np(got), _np(want),
                                           err_msg=f"{lhs}/{out}", **F32)
                assert (_np(got) >= 0).all()

    def test_batch_axis_broadcasts(self):
        w, p = _data(3, (24, 16), (5, 16, 30))
        got = matmul(torch.from_numpy(w), torch.from_numpy(p),
                     out_layout="nm")
        for i in range(5):
            want = r_matmul.matmul(jnp.asarray(w), jnp.asarray(p[i]),
                                   out_layout="nm")
            np.testing.assert_allclose(_np(got[i]), _np(want), **F32)


class TestConvDirect:
    @pytest.mark.parametrize("h,w,c,m,k,stride,pad", [
        (14, 14, 16, 32, 3, 1, 1),
        (13, 9, 8, 16, 3, 2, 1),
        (27, 27, 3, 16, 5, 2, 2),
        (12, 12, 4, 8, 1, 1, 0),
        (10, 10, 8, 130, 3, 1, 1),
        (31, 31, 3, 8, 11, 4, 0),    # AlexNet conv1 shape family
    ])
    def test_shapes(self, h, w, c, m, k, stride, pad):
        x, wt, b = _data(h * c + m, (h, w, c), (k, k, c, m), (m,),
                         scale=0.1)
        want = r_direct.conv_direct(jnp.asarray(x), jnp.asarray(wt),
                                    jnp.asarray(b), stride=stride, pad=pad)
        got = conv_direct(torch.from_numpy(x), torch.from_numpy(wt),
                          torch.from_numpy(b), stride=stride, pad=pad)
        np.testing.assert_allclose(_np(got), _np(want), **F32)

    @pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
    def test_2byte_dtypes(self, dtype):
        """bf16 and f16: f32 accumulation, the output in the dtype."""
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        x, wt, b = _data(12, (13, 11, 8), (3, 3, 8, 24), (24,), scale=0.1)
        for li, lo in (("HWC", "HWC"), ("CHW", "CHW")):
            xin = np.transpose(x, (2, 0, 1)).copy() if li == "CHW" else x
            want = r_direct.conv_direct(
                jnp.asarray(xin, jd), jnp.asarray(wt, jd),
                jnp.asarray(b, jd), stride=1, pad=1, in_layout=li,
                out_layout=lo)
            got = conv_direct(torch.from_numpy(xin).to(td),
                              torch.from_numpy(wt).to(td),
                              torch.from_numpy(b).to(td), stride=1, pad=1,
                              in_layout=li, out_layout=lo)
            assert got.dtype == td
            np.testing.assert_allclose(_np(got), _np(want),
                                       err_msg=f"{li}->{lo}", **BF16)

    def test_layouts(self):
        x, wt, b = _data(11, (9, 11, 8), (3, 3, 8, 16), (16,), scale=0.1)
        for li in ("CHW", "HWC"):
            xin = np.transpose(x, (2, 0, 1)).copy() if li == "CHW" else x
            for lo in ("CHW", "HWC"):
                want = r_direct.conv_direct(
                    jnp.asarray(xin), jnp.asarray(wt), jnp.asarray(b),
                    stride=1, pad=1, in_layout=li, out_layout=lo)
                got = conv_direct(torch.from_numpy(xin), torch.from_numpy(wt),
                                  torch.from_numpy(b), stride=1, pad=1,
                                  in_layout=li, out_layout=lo)
                np.testing.assert_allclose(_np(got), _np(want),
                                           err_msg=f"{li}->{lo}", **F32)


class TestConvIm2col:
    @pytest.mark.parametrize("h,w,c,m,k,stride,pad", [
        (14, 14, 16, 32, 3, 1, 1),
        (27, 27, 3, 16, 11, 4, 0),   # AlexNet conv1 shape family
        (9, 13, 8, 24, 5, 1, 2),
        (7, 7, 32, 8, 1, 1, 0),
    ])
    def test_shapes(self, h, w, c, m, k, stride, pad):
        x, wt, b = _data(h * c + k, (c, h, w), (m, c, k, k), (m,),
                         scale=0.1)
        for li, lo in (("CHW", "CHW"), ("HWC", "HWC")):
            xin = np.transpose(x, (1, 2, 0)).copy() if li == "HWC" else x
            want = r_im2col.conv_im2col(
                jnp.asarray(xin), jnp.asarray(wt), jnp.asarray(b),
                stride=stride, pad=pad, in_layout=li, out_layout=lo)
            got = conv_im2col(torch.from_numpy(xin), torch.from_numpy(wt),
                              torch.from_numpy(b), stride=stride, pad=pad,
                              in_layout=li, out_layout=lo)
            np.testing.assert_allclose(_np(got), _np(want), err_msg=li,
                                       **F32)

    def test_unfold_rows_match_xla_patch_order(self):
        """F.unfold's patch rows run (C, kh, kw), as the reference's
        ``lax.conv_general_dilated_patches`` rows do."""
        from jax import lax
        (x,) = _data(5, (3, 9, 8))
        want = lax.conv_general_dilated_patches(
            jnp.asarray(x)[None], (3, 3), (2, 2), [(1, 1)] * 2,
            dimension_numbers=("NCHW", "OIHW", "NCHW"))[0]
        got = torch.nn.functional.unfold(torch.from_numpy(x)[None], (3, 3),
                                         padding=1, stride=2)[0]
        np.testing.assert_array_equal(_np(got),
                                      _np(want).reshape(27, -1))

    def test_plain_version_matches_oracle(self):
        x, wt, b = _data(9, (2, 8, 12, 12), (16, 8, 3, 3), (16,), scale=0.1)
        got = conv_im2col_ref(torch.from_numpy(x), torch.from_numpy(wt),
                              torch.from_numpy(b), stride=2, pad=1)
        for i in range(2):
            want = r_im2col.conv_im2col_ref(jnp.asarray(x[i]),
                                            jnp.asarray(wt), jnp.asarray(b),
                                            stride=2, pad=1)
            np.testing.assert_allclose(_np(got[i]), _np(want), **F32)


class TestWinogradGemm:
    @pytest.mark.parametrize("p,m,c,n", [(16, 32, 64, 128), (36, 8, 16, 49)])
    def test_bgemm(self, p, m, c, n):
        """The reference's form, (P, M, C) x (P, C, N) -> (P, M, N)."""
        u, v = _data(p + n, (p, m, c), (p, c, n))
        want = r_wino.winograd_bgemm_pallas(jnp.asarray(u), jnp.asarray(v),
                                            bn=n if n % 128 else 128, bc=c)
        got = winograd_bgemm(torch.from_numpy(u), torch.from_numpy(v))
        assert got.shape == (p, m, n)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        np.testing.assert_allclose(
            _np(bgemm_ref(torch.from_numpy(u), torch.from_numpy(v))),
            _np(r_wino.bgemm_ref(jnp.asarray(u), jnp.asarray(v))), **F32)

    @pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
    def test_bgemm_2byte_dtypes(self, dtype):
        """bf16 and f16 operands: f32 accumulation, Q in the dtype."""
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        u, v = _data(17, (16, 24, 40), (16, 40, 49))
        want = r_wino.winograd_bgemm_pallas(jnp.asarray(u, jd),
                                            jnp.asarray(v, jd), bn=49,
                                            bc=40)
        got = winograd_bgemm(torch.from_numpy(u).to(td),
                             torch.from_numpy(v).to(td))
        assert got.dtype == td
        np.testing.assert_allclose(_np(got), _np(want), **BF16)

    @pytest.mark.parametrize("images", [1, 3])
    def test_bgemm_per_image_form(self, images):
        """The (images, P, C, T) form: one reference product per image."""
        u, v = _data(images, (16, 8, 24), (images, 16, 24, 49))
        got = winograd_bgemm(torch.from_numpy(u), torch.from_numpy(v))
        assert got.shape == (images, 16, 8, 49)
        for i in range(images):
            want = r_wino.winograd_bgemm_pallas(jnp.asarray(u),
                                                jnp.asarray(v[i]), bn=49,
                                                bc=24)
            np.testing.assert_allclose(_np(got[i]), _np(want), **F32)

    def test_prepare_kernel_packs_m_contiguous(self):
        """U's values are the reference's; its memory is (P, C, M)."""
        wt, = _data(3, (12, 5, 3, 3))
        u = prepare_kernel(wt, 4)
        assert u.shape == (36, 12, 5) and u.stride() == (60, 1, 12)
        np.testing.assert_array_equal(u.numpy(),
                                      np.asarray(r_wino.prepare_kernel(wt, 4)))

    @pytest.mark.parametrize("m_", [2, 4])
    @pytest.mark.parametrize("li,lo", [("CHW", "CHW"), ("HWC", "HWC"),
                                       ("CHW", "HWC")])
    def test_batch_folds_into_n(self, m_, li, lo):
        """A batch of 3 images (folded into the GEMM's N) against the
        reference's conv_winograd on each image."""
        x, wt, b = _data(m_ + 40, (3, 8, 13, 11), (16, 8, 3, 3), (16,),
                         scale=0.1)
        u_ref = r_wino.prepare_kernel(wt, m_)
        xin = np.transpose(x, (0, 2, 3, 1)).copy() if li == "HWC" else x
        got = conv_winograd(torch.from_numpy(xin), prepare_kernel(wt, m_),
                            torch.from_numpy(b), m_=m_, k=3, pad=1,
                            in_layout=li, out_layout=lo)
        for i in range(3):
            want = r_wino.conv_winograd(
                jnp.asarray(xin[i]), u_ref, jnp.asarray(b), m_=m_, k=3,
                pad=1, in_layout=li, out_layout=lo)
            np.testing.assert_allclose(_np(got[i]), _np(want),
                                       err_msg=f"image {i} {li}->{lo}",
                                       **F32)

    @pytest.mark.parametrize("m_", [2, 4])
    @pytest.mark.parametrize("h,w,c,m", [(14, 14, 8, 16), (9, 11, 4, 8)])
    def test_full_conv(self, m_, h, w, c, m):
        x, wt, b = _data(h + c + m_, (c, h, w), (m, c, 3, 3), (m,),
                         scale=0.1)
        u_ref = r_wino.prepare_kernel(wt, m_)
        u = prepare_kernel(wt, m_)
        np.testing.assert_array_equal(u.numpy(), np.asarray(u_ref))
        for li, lo in (("CHW", "CHW"), ("HWC", "HWC"), ("CHW", "HWC")):
            xin = np.transpose(x, (1, 2, 0)).copy() if li == "HWC" else x
            want = r_wino.conv_winograd(
                jnp.asarray(xin), u_ref, jnp.asarray(b), m_=m_, k=3, pad=1,
                in_layout=li, out_layout=lo)
            got = conv_winograd(torch.from_numpy(xin), u,
                                torch.from_numpy(b), m_=m_, k=3, pad=1,
                                in_layout=li, out_layout=lo)
            np.testing.assert_allclose(_np(got), _np(want),
                                       err_msg=f"{li}->{lo}", **F32)


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self):
        common.reset_launch_counts()
        x, y = _data(1, (8, 8), (8, 8))
        out = matmul(torch.from_numpy(x), torch.from_numpy(y))
        assert out.device.type == "cpu"
        assert common.launch_counts() == {}

    def test_other_devices_raise(self):
        x = torch.zeros((4, 4), device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            matmul(x, x)
        with pytest.raises(ValueError, match="CUDA tensors"):
            common.require_cuda(torch.zeros(2), x)

    def test_true_f32_is_scoped(self):
        mm = torch.backends.cuda.matmul.allow_tf32
        dnn = torch.backends.cudnn.allow_tf32
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            with common.true_f32():
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = mm
            torch.backends.cudnn.allow_tf32 = dnn

    def test_true_f32_holds_while_any_thread_is_inside(self):
        """A server's worker captures in ``true_f32`` while the caller
        runs another executable in it: the first one out must not turn
        TF32 back on under the other (the flags are process-wide)."""
        import threading
        mm = torch.backends.cuda.matmul.allow_tf32
        dnn = torch.backends.cudnn.allow_tf32
        inside, leave, seen = threading.Event(), threading.Event(), []

        def worker():
            with common.true_f32():
                inside.set()
                leave.wait(10)
                seen.append((torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32))

        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            t = threading.Thread(target=worker)
            with common.true_f32():
                t.start()
                assert inside.wait(10)
            leave.set()  # the caller left first; the worker reads now
            t.join(10)
            assert not t.is_alive() and seen == [(False, False)]
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = mm
            torch.backends.cudnn.allow_tf32 = dnn

    def test_recording_launches_counts_this_thread_only(self):
        import threading
        common.reset_launch_counts()
        with common.recording_launches() as rec:
            common.count_launch("matmul")
            t = threading.Thread(target=common.count_launch,
                                 args=("conv_direct",))
            t.start()
            t.join(10)
        common.count_launch("matmul")
        # recorded, not counted, inside the block; the other thread counts
        assert rec == {"matmul": 1}
        assert common.launch_counts() == {"matmul": 1, "conv_direct": 1}
        common.add_launches(rec)
        assert common.launch_counts() == {"matmul": 2, "conv_direct": 1}
        common.reset_launch_counts()

    def test_resolve_device(self):
        assert common.resolve_device("cpu").type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                common.resolve_device(None)

    def test_bindings_refuse_cpu_tensors(self):
        from repro_torch.kernels.conv_direct import conv_direct_cuda
        from repro_torch.kernels.matmul import matmul_cuda
        from repro_torch.kernels.winograd_gemm import winograd_bgemm_cuda
        x = torch.zeros((4, 4))
        with pytest.raises(ValueError, match="CUDA tensors"):
            matmul_cuda(x, x)
        with pytest.raises(ValueError, match="CUDA tensors"):
            winograd_bgemm_cuda(x[None], x[None, None])
        with pytest.raises(ValueError, match="CUDA tensors"):
            conv_direct_cuda(torch.zeros((1, 4, 4, 2)),
                             torch.zeros((1, 1, 2, 3)), torch.zeros(3))

    def test_build_all_waits_for_every_compiler(self, tmp_path):
        import subprocess
        import sys

        class FakeLib(common.KernelLib):
            """Stands in for nvcc: sleeps, writes its output, exits."""

            def __init__(self, rc):
                super().__init__("matmul.cu", {})
                self.rc, self.proc = rc, None

            @property
            def so_path(self):
                return tmp_path / f"lib{self.rc}.so"

            def start_build(self):
                code = ("import sys, time; time.sleep(0.3); "
                        "open(sys.argv[-1], 'w').close(); "
                        f"sys.exit({self.rc})")
                self.proc = subprocess.Popen(
                    [sys.executable, "-c", code, "-o",
                     str(tmp_path / f"tmp{self.rc}")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                return self.proc

        bad, good = FakeLib(3), FakeLib(0)
        with pytest.raises(RuntimeError, match="exit 3"):
            common.build_all([bad, good])
        assert bad.proc.returncode == 3 and good.proc.returncode == 0
        assert good.so_path.exists() and not bad.so_path.exists()

    def test_cdiv(self):
        assert [common.cdiv(a, 4) for a in (0, 1, 4, 5)] == [0, 1, 1, 2]

    def test_kernel_library_paths_follow_the_sources(self):
        from repro_torch.kernels import kernel_libs
        libs = kernel_libs()
        assert {lib.source.name for lib in libs} == {
            "matmul.cu", "winograd_gemm.cu", "conv_direct.cu",
            "layout_transform.cu", "flash_attention.cu"}
        for lib in libs:
            assert lib.source.exists()
            assert lib.so_path.parent == common.BUILD_DIR
            assert lib.so_path.name.startswith(lib.source.stem + "-")
