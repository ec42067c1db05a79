"""The launch planner of the Hopper GEMM mainloop, on the CPU.

``kernels/matmul/plan.py`` picks, for every launch of the GEMM (K1, K2)
and of the direct conv's implicit GEMM (K4), the output tile, the number
of K splits S (one cluster of S blocks per output tile) and the copy
widths, and hands them to the C entries.  No kernel runs here; these
tests hold the plans to what the kernels need: the grid covers every
output element exactly once, the K slices partition [0, K) with none
empty, S <= 8 and S divides the cluster's grid axis, 16-byte copies only
where the strides and the base allow them, and at batch 1 AlexNet's
conv3-conv5 fill at least 96 blocks.  The kernels themselves are checked
on the card (tests/test_torch_card.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.convnets import alexnet, googlenet
from repro_torch.kernels.common import cdiv, ptxas_usage
from repro_torch.kernels.conv_direct import conv_plan
from repro_torch.kernels.matmul import matmul_plan, plan_gemm
from repro_torch.kernels.matmul import plan as P

ALEX = {n.id: n.scn for n in alexnet(1.0).conv_nodes()}
#: (M, N, K) of AlexNet's five im2col GEMMs: (M, CKK) @ (CKK, OH*OW)
IM2COL = {nid: (s.m, s.out_h * s.out_w, s.c * s.k * s.k)
          for nid, s in ALEX.items()}
#: GoogLeNet's distinct 1x1 GEMMs: (M, C) @ (C, OH*OW)
PW = sorted({(s.m, s.out_h * s.out_w, s.c) for s in
             (n.scn for n in googlenet(1.0).conv_nodes()) if s.k == 1})
RAGGED = [(1, 1, 1), (1, 7, 5), (5, 1, 3), (3, 4, 1), (64, 129, 1),
          (70, 33, 9), (70, 33, 0), (8, 2, 40), (70, 33, 1000),
          (33, 129, 777), (129, 31, 1500), (200, 300, 17)]


def check_plan(plan, m, n, k, batch):
    """The invariants every launch of the mainloop relies on."""
    s = plan.splits
    bm, bn, bk = P.TILES[plan.tile]
    assert 1 <= s <= P.MAX_SPLITS
    assert plan.grid == (cdiv(n, bn) * s, cdiv(m, bm), batch)
    assert plan.grid[0] % s == 0  # whole clusters on grid x
    assert plan.vec_a in (1, 4) and plan.vec_b in (1, 4)
    # the output tiles: every element of C once per image
    cover = np.zeros((m, n), np.int32)
    for ty in range(plan.grid[1]):
        for tx in range(plan.grid[0] // s):
            assert ty * bm < m and tx * bn < n  # no empty tile
            cover[ty * bm:(ty + 1) * bm, tx * bn:(tx + 1) * bn] += 1
    assert (cover == 1).all()
    # the K slices: contiguous, whole steps, none empty
    assert plan.kslice % bk == 0 and plan.kslice >= 1
    assert s == 1 or plan.kslice >= P.MIN_STEPS * bk
    ranges = [plan.k_range(i, k) for i in range(s)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    assert all(hi > lo for lo, hi in ranges) or k == 0
    # the cluster's reduction: rank q stores runs [q R / S, (q+1) R / S)
    runs = bm * bn // 4
    owned = [r for q in range(s) for r in range(q * runs // s,
                                                (q + 1) * runs // s)]
    assert owned == list(range(runs))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("nid", sorted(IM2COL))
def test_alexnet_im2col(nid, batch):
    m, n, k = IM2COL[nid]
    check_plan(plan_gemm(m, n, k, batch), m, n, k, batch)


@pytest.mark.parametrize("nid", ["conv3", "conv4", "conv5"])
def test_alexnet_long_k_fills_the_card(nid):
    """Batch 1: 12 to 18 output tiles of 64 x 64 over K = 2304 or 3456;
    split-K takes each to 90 or 96 blocks (one block per tile before):
    the plans that the sweep of every tile and split count found fastest
    on the H100 (5 splits at conv3 and conv4, 8 at conv5)."""
    m, n, k = IM2COL[nid]
    plan = plan_gemm(m, n, k)
    want = {"conv3": 5, "conv4": 5, "conv5": 8}[nid]
    assert (plan.bm, plan.bn, plan.splits) == (64, 64, want)
    assert plan.blocks >= 90


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("chw_out", [False, True])
@pytest.mark.parametrize("nid", ["conv1", "conv2"])
def test_conv_direct(nid, chw_out, batch):
    """K4's implicit GEMM: (OH*OW x K*K*C) @ (K*K*C x M) for an HWC
    output, the transpose for a CHW one."""
    s = ALEX[nid]
    p, r = s.out_h * s.out_w, s.k * s.k * s.c
    plan = conv_plan(batch, s.c, s.m, s.k, s.out_h, s.out_w, chw_out, 4)
    rows, cols = (s.m, p) if chw_out else (p, s.m)
    check_plan(plan, rows, cols, r, batch)
    assert plan == plan_gemm(rows, cols, r, batch,
                             vec_a=4 if chw_out else 1,
                             vec_b=1 if chw_out else 4, tiles=(0, 1))
    assert plan.tile in (0, 1)  # the gather is slow on the narrow tiles
    assert plan.blocks >= 96  # conv1: 96 tiles of 64; conv2: 48


#: (M, C) of the Winograd GEMM at AlexNet's conv3-conv5, and (P, T) at
#: F(2,3) and F(4,3) (13 x 13 outputs)
WINO_MC = [(ALEX[nid].m, ALEX[nid].c) for nid in ("conv3", "conv4",
                                                   "conv5")]
WINO_PT = [(16, 49), (36, 16)]


@pytest.mark.parametrize("images", [1, 8])
@pytest.mark.parametrize("p,t", WINO_PT)
@pytest.mark.parametrize("m,c", WINO_MC)
def test_winograd_bgemm(m, c, p, t, images):
    """K3: (M, C) @ (C, images * T) over the P points, U's copies 16
    bytes (prepare_kernel packs M contiguous), V's where N allows."""
    n = images * t
    plan = plan_gemm(m, n, c, p, vec_a=4, vec_b=4 if n % 4 == 0 else 1)
    check_plan(plan, m, n, c, p)
    assert plan.vec_a == 4


@pytest.mark.parametrize("tile", [2, 3])
def test_narrow_tiles(tile):
    """The 128 x 32 and 128 x 16 tiles: runnable plans at any split
    count."""
    bm, bn, bk = P.TILES[tile]
    assert (bm, bn) == ((128, 32), (128, 16))[tile - 2]
    for m, n, k in [(384, 16, 384), (70, 33, 1000), (5, 1, 3)]:
        for s in range(1, P.MAX_SPLITS + 1):
            splits, kslice = P._splits(k, bk, s)
            plan = P.GemmPlan(tile, splits, kslice, 1, 1,
                              (cdiv(n, bn) * splits, cdiv(m, bm), 1))
            check_plan(plan, m, n, k, 1)


def test_short_n_takes_a_narrow_tile():
    """F(4,3) at batch 1: N = 16 columns over 36 points."""
    assert plan_gemm(384, 16, 384, 36, vec_a=4, vec_b=4).bn <= 32


@pytest.mark.parametrize("m,n,k", PW)
def test_googlenet_pointwise(m, n, k):
    check_plan(plan_gemm(m, n, k), m, n, k, 1)


@pytest.mark.parametrize("m,n,k", RAGGED)
@pytest.mark.parametrize("batch", [1, 3])
def test_ragged(m, n, k, batch):
    check_plan(plan_gemm(m, n, k, batch), m, n, k, batch)


def test_bf16_copies_through_registers():
    plan = plan_gemm(96, 784, 192, dtype=torch.bfloat16, vec_a=4, vec_b=4)
    assert (plan.vec_a, plan.vec_b) == (1, 1)
    assert plan_gemm(96, 784, 192, vec_a=4, vec_b=4).vec_b == 4


def test_refuses_what_no_kernel_runs():
    with pytest.raises(ValueError):
        plan_gemm(0, 4, 4)
    with pytest.raises(ValueError):
        plan_gemm(4, 4, -1)
    with pytest.raises(TypeError):
        plan_gemm(4, 4, 4, dtype=torch.float64)
    # bf16 and f16 are planned too, their copies 2 bytes through registers
    for dt in (torch.bfloat16, torch.float16):
        plan = plan_gemm(4, 4, 4, dtype=dt, vec_a=4, vec_b=4)
        assert (plan.vec_a, plan.vec_b) == (1, 1)


def test_plans_are_pure():
    assert plan_gemm(384, 169, 2304) == plan_gemm(384, 169, 2304)
    assert plan_gemm(384, 169, 2304) != plan_gemm(384, 169, 2304, 8)


class TestVectorWidth:
    """16-byte copies need the staged axis contiguous and every other
    stride and the base 16-byte aligned."""

    def test_contiguous_rows(self):
        assert P.vector_width(torch.zeros(2, 64, 784), 2) == 4

    def test_odd_row_length(self):
        # AlexNet's patch matrices: OH*OW = 3025, 729, 169
        assert P.vector_width(torch.zeros(1, 363, 3025), 2) == 1

    def test_staged_axis_not_contiguous(self):
        t = torch.zeros(1, 64, 192)  # A (M, K) row-major: M is not fast
        assert P.vector_width(t, 1) == 1
        # its transposed view (192, 64) walks dim 1 contiguously
        assert P.vector_width(t.transpose(1, 2), 1) == 4
        assert P.vector_width(t.transpose(1, 2), 2) == 1

    def test_misaligned_base(self):
        t = torch.zeros(1 + 8 * 64)[1:].view(1, 8, 64)
        assert t.data_ptr() % 16 != 0
        assert P.vector_width(t, 2) == 1

    def test_misaligned_stride(self):
        t = torch.zeros(6, 10)[:, :8]  # rows 10 floats apart
        assert P.vector_width(t.unsqueeze(0), 2) == 1

    def test_broadcast_batch(self):
        t = torch.zeros(1, 16, 64).expand(5, 16, 64)  # batch stride 0
        assert P.vector_width(t, 2) == 4

    def test_extent_one_axes_do_not_count(self):
        t = torch.zeros(7, 64)[:1].unsqueeze(0)  # (1, 1, 64), odd strides
        assert P.vector_width(t.as_strided((1, 1, 64), (3, 5, 1)), 2) == 4

    def test_bf16(self):
        assert P.vector_width(torch.zeros(1, 8, 64, dtype=torch.bfloat16),
                              2) == 1

    @pytest.mark.parametrize("lhs", ["mk", "km"])
    def test_matmul_plan(self, lhs):
        """The binding's operands: a "km" LHS stages M contiguously."""
        w = torch.zeros(64, 192)
        x = w.T.contiguous() if lhs == "km" else w
        plan = matmul_plan(x, torch.zeros(192, 784), lhs_layout=lhs)
        assert plan.vec_a == (4 if lhs == "km" else 1)
        assert plan.vec_b == 4
        check_plan(plan, 64, 784, 192, 1)


def test_ptxas_usage():
    report = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z4gemmv' for 'sm_90a'
ptxas info    : Function properties for _Z4gemmv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 183 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z4convv' for 'sm_90a'
ptxas info    : Function properties for _Z4convv
    24 bytes stack frame, 20 bytes spill stores, 72 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8704 bytes smem
"""
    assert ptxas_usage(report) == {
        "_Z4gemmv": {"registers": 183, "smem": 0, "stack": 0, "spill": 0},
        "_Z4convv": {"registers": 128, "smem": 8704, "stack": 24,
                     "spill": 92}}
