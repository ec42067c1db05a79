"""The flash-attention launch planner (``kernels/flash_attention/plan.py``).

Pure Python: the planner is a function of the shape, so its picks are
pinned here on the CPU.  The picks at the calibration sweep's shapes are
the ones its constants were fitted to (PERF.md, PR 16); the card checks
each plan's output (tests/test_torch_card.py, chip_smoke.py).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import plan as fp
from repro_torch.kernels.flash_attention.kernel import attention_plan

#: the most dynamic shared memory one block may use on an H100
SMEM_LIMIT = 232448


@pytest.mark.parametrize("dp", fp.HEAD_WIDTHS)
@pytest.mark.parametrize("bq", fp.QUERY_TILES)
def test_every_instantiation_fits_shared_memory(dp, bq):
    """Q tile + ring of K/V tiles + P tile, f32, within 227 KB; the
    key tile and the stages shrink as the head dim grows."""
    bkv = fp.kv_tile(dp)
    stages = 3 if dp == 32 else 2
    want = 4 * (bq * (dp + 4) + stages * 2 * bkv * (dp + 4)
                + bq * (bkv + 8))
    assert fp.smem_bytes(dp, bq) == want <= SMEM_LIMIT
    assert fp.threads(dp, bq) in (64, 128, 256)
    # a warp holds 16 query rows (8 at DP = 256)
    assert fp.threads(dp, bq) // 32 * (16 if dp <= 128 else 8) == bq


@pytest.mark.parametrize("d,dp", [(1, 32), (7, 32), (16, 32), (32, 32),
                                  (33, 64), (64, 64), (112, 128),
                                  (128, 128), (200, 256), (256, 256),
                                  (320, 256), (1000, 256)])
def test_padded_dim(d, dp):
    assert fp.padded_dim(d) == dp


#: (B, Hq, Lq, Lk, D) -> (DP, BQ, S, slices, blocks)
PICKS = {
    # the calibration sweep's two shapes: the fastest plans of the sweep
    # (46.1 and 12.0 us); at L = 256 the 4 KV tiles cap S at 4, and 64
    # blocks of one tile beat 128 blocks of BQ 32 (12.6 us)
    (1, 4, 1024, 1024, 64): (64, 64, 2, 1, 128),
    (1, 4, 256, 256, 64): (64, 64, 4, 1, 64),
    # every padded width and the sliced path, at L = 1024 and 256
    (1, 4, 1024, 1024, 16): (32, 64, 2, 1, 128),
    (1, 4, 1024, 1024, 32): (32, 64, 2, 1, 128),
    (1, 4, 1024, 1024, 112): (128, 64, 2, 1, 128),
    (1, 4, 1024, 1024, 128): (128, 64, 2, 1, 128),
    (1, 4, 1024, 1024, 256): (256, 64, 2, 1, 128),
    (1, 4, 1024, 1024, 320): (256, 32, 1, 2, 256),
    (1, 4, 256, 256, 16): (32, 64, 4, 1, 64),
    (1, 4, 256, 256, 112): (128, 64, 8, 1, 128),
    (1, 4, 256, 256, 256): (256, 64, 8, 1, 128),
    (1, 4, 256, 256, 320): (256, 32, 2, 2, 128),
}


@pytest.mark.parametrize("shape", list(PICKS))
def test_planner_picks(shape):
    plan = fp.plan_attention(*shape)
    dp, bq, splits, slices, blocks = PICKS[shape]
    assert (plan.dp, plan.bq, plan.splits, plan.slices, plan.blocks) == (
        dp, bq, splits, slices, blocks), plan.describe()
    b, hq, lq, _, _ = shape
    assert plan.grid == (-(-lq // bq) * splits, hq * slices, b)
    assert plan.smem <= SMEM_LIMIT


def test_the_split_fills_one_round_and_no_more():
    """At the long sweep shape one block per query tile gives 64 blocks;
    the planner splits the KV range until the card holds one block per
    SM (128 of 132), where the sweep found it fastest: more blocks than
    a round (S = 3 to 8) ran 20-40 % slower."""
    plan = fp.plan_attention(1, 4, 1024, 1024, 64)
    assert plan.blocks // plan.splits == 64 and plan.blocks == 128
    for s in range(3, 9):
        assert fp._model_us(64, 64, 64 * s, s, 16) > fp._model_us(
            64, 64, 128, 2, 16)


@pytest.mark.parametrize("d", [16, 32, 112, 128, 256, 320])
@pytest.mark.parametrize("lk", [1, 50, 256, 4096])
def test_no_rank_is_planned_empty(d, lk):
    """S never exceeds the KV tiles, and a sliced head dim runs at BQ 32
    (the one sliced instantiation)."""
    plan = fp.plan_attention(2, 8, 300, lk, d)
    assert 1 <= plan.splits <= min(fp.MAX_SPLITS,
                                   max(1, -(-lk // plan.bkv)))
    assert plan.dp == fp.padded_dim(d)
    if d > 256:
        assert plan.bq == 32 and plan.slices == -(-d // 256)
    else:
        assert plan.slices == 1 and plan.dp >= d


def test_plan_follows_the_operands():
    q = torch.zeros((2, 8, 300, 112))
    k = torch.zeros((2, 2, 77, 112))
    assert attention_plan(q, k, k) == fp.plan_attention(2, 8, 300, 77, 112)
    # sequence-major: (B, L, H, D)
    ql, kl = q.transpose(1, 2), k.transpose(1, 2)
    assert attention_plan(ql, kl, kl, seq_major=True) == \
        fp.plan_attention(2, 8, 300, 77, 112)
    assert attention_plan(q, k, k, lk_valid=40) == \
        fp.plan_attention(2, 8, 300, 40, 112)


def test_bad_problems_are_refused():
    with pytest.raises(ValueError):
        fp.plan_attention(1, 4, 0, 16, 64)
    with pytest.raises(ValueError):
        fp.padded_dim(0)
    with pytest.raises(TypeError):
        fp.plan_attention(1, 4, 16, 16, 64, torch.float64)
    with pytest.raises(TypeError):
        attention_plan(*(torch.zeros((1, 2, 8, 8), dtype=torch.float64),) * 3)
