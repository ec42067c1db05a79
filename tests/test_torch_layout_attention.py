"""The port's layout transforms (K5) and flash attention (K6) against the
reference's Pallas ops.

On the CPU each wrapper runs its plain PyTorch version; the reference's
Pallas kernels run in interpret mode, as tests/test_kernels.py runs them.
Inputs are made with numpy from a seed and fed to both packages.

Tolerances: the layout transforms copy values, so they must be exactly
equal.  Flash attention in f32 within 2e-5 of the reference's largest
magnitude: both sides accumulate in f32, but the reference's online
softmax rescales block by block and sums in another order than the
port's dense plain version, a few f32 ulps of outputs of order 1.  bf16
and f16 within 2e-2: both outputs are rounded to bf16 (8 mantissa bits)
or f16 (11); the head dims below 64 and the odd 112 hold the same f32
bound.

The CUDA kernels themselves are compared with their plain versions on
the card by tests/test_torch_card.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layouts import ALL_LAYOUTS, LAYOUT_BY_NAME
from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import ops as r_fa
from repro.kernels.layout_transform import ops as r_lt
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.layout_transform import kernel as lt_kernel
from repro_torch.kernels.layout_transform import ops as p_lt

F32_REL = 2e-5
BF16_REL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


# ----------------------------------------------------------------------
# K5: layout transforms
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 13, 13), (8, 7, 130), (96, 27, 27),
                                   (256, 16, 16)])
def test_layout_transforms_equal_the_reference(shape):
    c, h, w = shape
    x = _rng(c * h * w).normal(size=shape).astype(np.float32)
    hwc = np.ascontiguousarray(x.transpose(1, 2, 0))
    cases = [("chw_to_hwc", x), ("hwc_to_chw", hwc)]
    if c % 8 == 0:
        cases += [("chw_to_hwc8", x),
                  ("hwc8_to_chw", hwc.reshape(h, w, c // 8, 8))]
    for name, a in cases:
        want = np.asarray(getattr(r_lt, name)(jnp.asarray(a)))
        got = getattr(p_lt, name)(torch.from_numpy(a.copy())).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("c", [1, 3, 4, 8])
def test_short_channel_axis_takes_the_short_route(c):
    """conv1's bucket (C = 3 or 4) and other short channel axes: each
    thread moves a pixel's whole run of channels, both ways, in 1-, 2-,
    4- and 8-byte elements; a run of 64 bytes from CHW (8 channels of
    8 bytes) goes to the tile, whose 16-byte accesses beat the short rows
    there."""
    for esize in (1, 2, 4, 8):
        rows = lt_kernel.TILE if c * esize >= lt_kernel.SHORT_BYTES else \
            lt_kernel.SHORT_ROWS
        assert lt_kernel.route(c, 256 * 256, esize) == rows
        assert lt_kernel.route(256 * 256, c, esize) == lt_kernel.SHORT_COLS
        assert lt_kernel.route(c, 13 * 17, esize) == rows
    assert lt_kernel.route(16, 4096, 4) == lt_kernel.TILE
    assert lt_kernel.route(12, 4096, 4) == lt_kernel.SHORT_ROWS
    assert lt_kernel.route(4096, 16, 4) == lt_kernel.SHORT_COLS


@pytest.mark.parametrize("c", [32, 96, 128, 512])
def test_long_axes_take_the_tile(c):
    for esize in (1, 2, 4, 8):
        assert lt_kernel.route(c, 27 * 27, esize) == lt_kernel.TILE
        assert lt_kernel.route(27 * 27, c, esize) == lt_kernel.TILE
    # a short axis longer than the kernel's registers hold
    assert lt_kernel.route(lt_kernel.SHORT_MAX + 1, 4096, 1) == \
        lt_kernel.TILE


@pytest.mark.parametrize("r,s,esize,batch", [
    (1449 * 1449, 32, 1, 1),      # hwc_to_chw of a (1449, 1449, 32) plane
    (32, 1449 * 1449, 1, 1),
    (1449 * 1449, 32, 4, 2),
    (4, 1449 * 1449, 4, 1),       # short rows
    (1449 * 1449, 4, 8, 1),       # short columns
    (3, 40, 1, 70000),
    (40, 3, 2, 70000),
    (96, 729, 4, 70000),
    (2 ** 31 - 1, 17, 1, 1),
])
def test_plan_takes_any_plane_and_batch(r, s, esize, batch):
    """No route's grid caps the planes or the batch: planes of more than
    2,097,120 positions (65535 tiles of 32 along R) and batches above
    65535 are planned, never refused.  The tile route's grid is 1-D, at
    most ``BLOCKS_PER_SM`` blocks per SM each striding over tiles; a
    short route's grid is the C entry's (a plane's blocks on x, the
    planes on (z, y)), so the plan carries none."""
    p = lt_kernel.plan(r, s, esize, batch)
    assert p.route == lt_kernel.route(r, s, esize)
    if p.route == lt_kernel.TILE:
        tr, ts = lt_kernel.tile_elems(p.tile, esize)
        assert p.units == batch * -(-r // tr) * -(-s // ts)
        assert 1 <= p.grid == min(p.units,
                                  lt_kernel.BLOCKS_PER_SM * lt_kernel.SMS)
    else:
        long_ = s if p.route == lt_kernel.SHORT_ROWS else r
        per_plane = -(-long_ // lt_kernel.SHORT_THREADS)
        assert per_plane < 2 ** 31
        assert p.units == batch * per_plane
        assert (p.tile, p.grid) == (0, 0)
    for tile in (0, 1):
        if lt_kernel.tile_built(tile, esize):
            q = lt_kernel.plan(r, s, esize, batch, route_=lt_kernel.TILE,
                               tile_=tile)
            assert 1 <= q.grid <= min(q.units, 2 ** 31 - 1)
    assert p.units < 2 ** 31


@pytest.mark.parametrize("esize", [1, 2, 4, 8])
def test_tiles_are_sized_in_bytes(esize):
    """The kernel builds an 8 KB and a 16 KB tile for each element size
    but f64 (8 KB only); each is (RB / e) x (SB / e) elements in 16-byte
    chunks both ways, with eight chunk groups for the swizzle, and the
    planner picks only tiles the kernel builds."""
    built = [t for t in (0, 1) if lt_kernel.tile_built(t, esize)]
    assert built == ([0] if esize == 8 else [0, 1])
    assert not lt_kernel.tile_built(2, esize)
    n = 16 // esize
    for tile in built:
        tr, ts = lt_kernel.tile_elems(tile, esize)
        assert tr * ts * esize == lt_kernel.TILE_BYTES[tile]
        rb, sb = tr * esize, ts * esize
        assert (rb, sb) in lt_kernel.SHAPES
        assert rb // 16 >= 8 and (sb // 16) * n >= 8
    for r, s, b in ((96, 729, 1), (64, 65536, 1), (64, 65536, 8),
                    (1449 * 1449, 32, 1), (17, 17, 1)):
        assert lt_kernel.pick_tile(r, s, esize, b) in built


def test_pick_tile_follows_the_planes_bytes():
    """The tile is sized in bytes: 8 KB (64 x 32 in f32) up to planes
    that hold four 16 KB tiles per SM, then 16 KB (64 x 64 in f32, above
    8 MiB of planes); 8 KB at a small plane in every element size; never
    smaller as the batch grows."""
    f32 = {(128, 1024): 0, (1024, 256): 0, (128, 16384): 0,
           (64, 65536): 1, (65536, 64): 1}
    for (r, s), want in f32.items():
        assert lt_kernel.pick_tile(r, s, 4) == want, (r, s)
    assert lt_kernel.tile_elems(0, 4) == (64, 32)
    assert lt_kernel.tile_elems(1, 4) == (64, 64)
    assert lt_kernel.pick_tile(128, 16384, 4, batch=2) == 1
    for esize in (1, 2, 4, 8):
        assert lt_kernel.pick_tile(96, 729, esize) == 0
        for r, s in ((96, 729), (256, 4096), (1024, 128), (64, 65536)):
            picks = [lt_kernel.TILE_BYTES[lt_kernel.pick_tile(
                r, s, esize, b)] for b in (1, 2, 8, 64)]
            assert picks == sorted(picks)


def test_layout_transforms_take_a_batch_axis():
    x = _rng(1).normal(size=(3, 16, 5, 9)).astype(np.float32)
    xt = torch.from_numpy(x)
    for name, back in (("chw_to_hwc", "hwc_to_chw"),
                       ("chw_to_hwc8", "hwc8_to_chw")):
        y = getattr(p_lt, name)(xt)
        for i in range(3):
            assert torch.equal(y[i], getattr(p_lt, name)(xt[i]))
        assert torch.equal(getattr(p_lt, back)(y), xt)
        assert y.is_contiguous()


@pytest.mark.parametrize("src", [l.name for l in ALL_LAYOUTS])
def test_convert_every_pair_equals_the_reference(src):
    shape = (16, 6, 10)
    x = _rng(2).normal(size=shape).astype(np.float32)
    xm = LAYOUT_BY_NAME[src].to_memory(x)
    for lay in ALL_LAYOUTS:
        want = np.asarray(r_lt.convert(jnp.asarray(xm), src, lay.name))
        common.reset_launch_counts()
        got = p_lt.convert(torch.from_numpy(xm.copy()), src, lay.name)
        assert common.launch_counts() == {}  # CPU: plain versions
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{src}->{lay.name}")
        np.testing.assert_array_equal(got.numpy(), lay.to_memory(x))


# ----------------------------------------------------------------------
# K6: flash attention
# ----------------------------------------------------------------------
#: (B, Hq, Hkv, Lq, Lk, D), dtype, options
FA_CASES = {
    "noncausal": ((1, 4, 4, 100, 100, 64), "float32", {}),
    "causal": ((1, 4, 4, 100, 100, 64), "float32", dict(causal=True)),
    "causal_window": ((1, 4, 4, 100, 100, 64), "float32",
                      dict(causal=True, window=16)),
    "softcap": ((1, 4, 4, 100, 100, 64), "float32", dict(softcap=5.0)),
    "gqa2": ((2, 4, 2, 100, 100, 64), "float32", {}),
    "gqa4": ((1, 8, 2, 100, 100, 64), "float32", dict(causal=True)),
    "lhd": ((2, 4, 2, 100, 100, 64), "float32",
            dict(layout="LHD", causal=True)),
    "masked_rows": ((1, 2, 2, 64, 16, 64), "float32",
                    dict(causal=True, window=8)),
    "bf16": ((1, 4, 4, 100, 100, 64), "bfloat16", {}),
    "head_dim_16": ((1, 4, 4, 100, 100, 16), "float32", dict(causal=True)),
    "head_dim_32": ((2, 4, 2, 100, 100, 32), "float32", {}),
    "head_dim_112": ((1, 4, 4, 100, 100, 112), "float32",
                     dict(softcap=5.0)),
    "f16": ((1, 4, 2, 100, 100, 64), "float16", dict(causal=True)),
}


def _qkv(dims, layout, seed):
    b, hq, hkv, lq, lk, d = dims
    lhd = layout == "LHD"
    qs = (b, lq, hq, d) if lhd else (b, hq, lq, d)
    ks = (b, lk, hkv, d) if lhd else (b, hkv, lk, d)
    rng = _rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in (qs, ks, ks)]


@pytest.mark.parametrize("case", list(FA_CASES))
def test_flash_attention_matches_the_reference(case):
    dims, dtype, kw = FA_CASES[case]
    q, k, v = _qkv(dims, kw.get("layout", "HLD"), len(case))
    want = np.asarray(r_fa.flash_attention(
        *(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
        **kw).astype(jnp.float32))
    got = flash_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        **kw)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    assert got.shape == want.shape
    tol = F32_REL if dtype == "float32" else BF16_REL
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale
    if case == "masked_rows":
        # keys 0..15 with window 8: rows 23 and up see no key -> 0
        assert (want[:, :, 23:] == 0).all() and (got[:, :, 23:] == 0).all()
        assert (np.abs(got[:, :, :23]).sum(-1) > 0).all()


def test_plain_version_follows_the_kernel_not_the_dense_oracle():
    """A fully masked row: the reference's dense oracle averages V, its
    kernel (and the port) output 0."""
    q, k, v = _qkv((1, 2, 2, 64, 16, 64), "HLD", 3)
    oracle = np.asarray(attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                      causal=True, window=8))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, window=8).numpy()
    assert np.abs(oracle[:, :, 23:]).max() > 0
    assert (got[:, :, 23:] == 0).all()
    np.testing.assert_allclose(got[:, :, :23], oracle[:, :, :23],
                               rtol=F32_REL, atol=F32_REL)


def test_flash_attention_scale_and_tiles():
    q, k, v = (torch.from_numpy(a) for a in
               _qkv((1, 2, 2, 40, 40, 64), "HLD", 5))
    base = flash_attention(q, k, v)
    assert torch.equal(flash_attention(q, k, v, scale=64 ** -0.5), base)
    assert torch.equal(flash_attention(q, k, v, bq=16, bk=8), base)
    assert not torch.equal(flash_attention(q, k, v, scale=0.5), base)
