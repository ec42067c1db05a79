"""The port's optimizers and gradient compression (``repro_torch.optim``)
against the reference's, on the CPU.

The same params and gradients (numpy, from a seed) go through both
packages' AdamW and Adafactor for 10 updates: params and every state
leaf within 1e-6 of the reference's largest magnitude per leaf (both
compute in f32 with the same formula; they differ only in summation
order inside the global norm and the means, ~1e-7).  The step count and
the state's structure are held exactly, as the checkpoint stores them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro.configs import get_config
from repro_torch import optim as T
from repro_torch import tree as pytree

REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in shapes.items()}


#: stacked like the models' leaves: a factored matrix, a 3-d stack whose
#: last two axes factor, one below ``min_dim``, a vector
SHAPES = {"w": (256, 160), "stack": (2, 128, 136), "small": (4, 8),
          "norm": (300,)}


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{err:.3e} > {rel} x {scale:.3e}"


def _close_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_tree(got[k], want[k])
        return
    _close(got.numpy(), want)


def _run(make, steps=10):
    """``steps`` updates of both packages' optimizer from the same params
    and a fresh gradient tree per step."""
    params = _tree(0, SHAPES)
    lr = dict(peak_lr=1e-2, warmup=3, total=12)
    ropt = make(R, R.warmup_cosine(**lr))
    topt = make(T, T.warmup_cosine(**lr))
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    rs, ts = ropt.init(rp), topt.init(tp)
    for step in range(steps):
        # large enough that the clip engages on some steps, not on others
        g = _tree(100 + step, SHAPES, scale=0.05 * (1 + step % 3))
        rp, rs = ropt.update({k: jnp.asarray(v) for k, v in g.items()},
                             rs, rp)
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
    return rp, rs, tp, ts


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_ten_updates_match_the_reference(name):
    def make(pkg, lr):
        if name == "adamw":
            return pkg.adamw(lr, weight_decay=0.1)
        return pkg.adafactor(lr, weight_decay=0.01)
    rp, rs, tp, ts = _run(make)
    _close_tree(tp, rp)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 10
    assert int(rs["count"]) == 10
    state = {k: v for k, v in rs.items() if k != "count"}
    _close_tree({k: v for k, v in ts.items() if k != "count"}, state)
    # the same leaves in the same order, as the checkpoint stores them
    assert [tuple(x.shape) for x in jax.tree.leaves(rs)] == \
        [tuple(x.shape) for x in pytree.leaves(ts)]


def test_adafactor_state_is_factored():
    opt = T.adafactor(lambda s: 1e-3)
    params = {"big": torch.zeros((256, 512)), "small": torch.zeros((4, 8)),
              "vec": torch.zeros((300,)),
              "stack": torch.zeros((3, 128, 200))}
    st = opt.init(params)
    assert set(st["f"]["big"]) == {"r", "c"}
    assert tuple(st["f"]["big"]["r"].shape) == (256,)
    assert tuple(st["f"]["big"]["c"].shape) == (512,)
    assert tuple(st["f"]["stack"]["r"].shape) == (3, 128)
    assert tuple(st["f"]["stack"]["c"].shape) == (3, 200)
    assert set(st["f"]["small"]) == {"v"}      # below min_dim: unfactored
    assert set(st["f"]["vec"]) == {"v"}
    ref = R.adafactor(lambda s: 1e-3).init(
        {k: jnp.zeros(tuple(v.shape)) for k, v in params.items()})
    got = jax.tree.map(lambda x: tuple(x.shape), ref)
    want = {"f": {k: {n: tuple(t.shape) for n, t in f.items()}
                  for k, f in st["f"].items()}, "count": ()}
    assert got == want


@pytest.mark.parametrize("max_norm", [1.0, 1e9])
def test_clip_by_global_norm(max_norm):
    tree = _tree(3, {"a": (10,), "b": (4, 5)})
    rc, rn = R.clip_by_global_norm({k: jnp.asarray(v)
                                    for k, v in tree.items()}, max_norm)
    tc, tn = T.clip_by_global_norm({k: torch.from_numpy(v)
                                    for k, v in tree.items()}, max_norm)
    assert float(tn) == pytest.approx(float(rn), rel=1e-6)
    _close_tree(tc, rc)
    assert float(T.global_norm(tc)) == pytest.approx(
        min(max_norm, float(rn)), rel=1e-5)
    if max_norm > float(rn):   # under the limit: untouched
        np.testing.assert_array_equal(tc["a"].numpy(), tree["a"])


@pytest.mark.parametrize("peak,warmup,total,floor", [
    (3e-4, 20, 20, 0.1), (1e-3, 10, 200, 0.1), (0.05, 0, 50, 0.0)])
def test_warmup_cosine(peak, warmup, total, floor):
    rl, tl = (pkg.warmup_cosine(peak, warmup, total, floor)
              for pkg in (R, T))
    for step in [0, 1, warmup // 2, warmup, warmup + 1, total // 2, total,
                 total + 7]:
        got = tl(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(rl(step)), rel=1e-6,
                                           abs=1e-12)
        assert float(tl(step)) == float(got)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "kimi-k2-1t-a32b",
                                  "grok-1-314b", "jamba-v0.1-52b"])
def test_for_config_picks_as_the_reference(arch):
    cfg = get_config(arch)
    r, t = R.for_config(cfg), T.for_config(cfg)
    # the pick shows in the state's keys: AdamW's m, v, Adafactor's f
    r_state = r.init({"w": jnp.zeros((4, 4), jnp.float32)})
    t_state = t.init({"w": torch.zeros(4, 4)})
    assert sorted(t_state) == sorted(r_state)


@pytest.mark.parametrize("shape,scale", [((1000,), 1.0), ((17, 33), 1e-3),
                                         ((64,), 0.0)])
def test_quantize_int8_matches_bit_for_bit(shape, scale):
    x = _tree(5, {"x": shape}, scale)["x"]
    rq, rs = R.quantize_int8(jnp.asarray(x))
    tq, ts = T.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    assert ts.item() == float(rs)
    np.testing.assert_array_equal(
        T.dequantize_int8(tq, ts).numpy(),
        np.asarray(R.dequantize_int8(rq, rs)))


def test_stochastic_rounding_is_unbiased():
    """With a generator the rounding is random and unbiased: the mean of
    many dequantised draws approaches x, where rounding to nearest keeps
    a bias of up to half a step."""
    x = torch.from_numpy(_tree(6, {"x": (256,)})["x"])
    x[0] = 127.0 * 3            # the scale: 3 per integer step
    x[1:] = x[1:] * 0.4 + 1.3   # off the grid
    gen = torch.Generator().manual_seed(0)
    draws = []
    for _ in range(2000):
        q, s = T.quantize_int8(x, gen)
        draws.append(T.dequantize_int8(q, s))
    mean = torch.stack(draws).mean(0)
    q0, s0 = T.quantize_int8(x)
    nearest_bias = (T.dequantize_int8(q0, s0) - x)[1:].abs().mean()
    stochastic_bias = (mean - x)[1:].abs().mean()
    assert float(nearest_bias) > 0.5
    assert float(stochastic_bias) < 0.1
    # a generator seeded alike draws alike
    a = T.quantize_int8(x, torch.Generator().manual_seed(4))[0]
    b = T.quantize_int8(x, torch.Generator().manual_seed(4))[0]
    assert torch.equal(a, b)
