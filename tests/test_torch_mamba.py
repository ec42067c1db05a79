"""The port's Mamba2 block (``repro_torch.models.mamba``) and the SSM and
hybrid families against the reference's, on the CPU.

Weights are the reference's ``init_params``/``init_from_defs(...,
jnp.float32)`` carried across as numpy; inputs come from a numpy seed.
Tolerance: ``REL`` = 1e-4 of the reference's largest magnitude, as in
``test_torch_models.py``.

The chunked scan sums each segment of log decays inside a chunk directly
(``sum_{s<r<=t} l_r``); the reference takes the difference of two prefix
sums, which loses up to |prefix| x 6e-8 of each exponent.  Against a
float64 sequential recurrence (``_recurrence64``) the port's ``ssd_chunked``
lies within 1.4e-7 of the largest magnitude on this file's inputs, the
reference's up to 3.7e-6; on ``jamba-v0.1-52b.scaled_down()`` (16 layers,
the stacked weights drawn with std 1/sqrt(2)) the reference's own f32
logits lie up to 1.0e-4 from a float64 evaluation of the same model, the
port's up to 1.4e-5, so the two stay within ``REL`` of each other.

The decode state: a Mamba layer's decode returns new ``ssm`` and
``conv`` tensors, which ``decode_step`` writes back into the cache in
place (as attention writes its new key and value).  The model tests
decode several steps and hold every step's logits and both states
against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config
from repro.models import mamba as RM
from repro.models.sharding import ShardingPlan as RPlan
from repro.models.sharding import init_from_defs
from repro_torch import models as T
from repro_torch.models import mamba as TM
from repro_torch.models.sharding import ShardingPlan as TPlan

REL = 1e-4
DECODE_STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= rel * scale, f"{err:.3e} > {rel} x {scale:.3e}"


def _ssd_inputs(seed, t, b=2, h=4, p=16, n=16):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=h)).astype(np.float32)
    B_ = rng.normal(size=(b, t, n)).astype(np.float32)
    C_ = rng.normal(size=(b, t, n)).astype(np.float32)
    s0 = rng.normal(size=(b, h, n, p)).astype(np.float32)
    return xh, dt, a, B_, C_, s0


def _recurrence64(xh, dt, a, B_, C_, s0):
    """The SSD recurrence token by token, in float64."""
    xh, dt, a, B_, C_ = (v.astype(np.float64) for v in (xh, dt, a, B_, C_))
    s = s0.astype(np.float64)
    ys = []
    for i in range(xh.shape[1]):
        s = s * np.exp(a[None] * dt[:, i])[..., None, None] + np.einsum(
            "bn,bhp,bh->bhnp", B_[:, i], xh[:, i], dt[:, i])
        ys.append(np.einsum("bn,bhnp->bhp", C_[:, i], s))
    return np.stack(ys, 1), s


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [16, 64, 256])
@pytest.mark.parametrize("t", [1, 7, 256, 300, 513])
def test_ssd_chunked(t, chunk, with_state):
    """Against the reference, padding (T not a multiple of the chunk)
    and an entering state included; both outputs and the final state."""
    xh, dt, a, B_, C_, s0 = _ssd_inputs(t + chunk, t)
    init = s0 if with_state else None
    ry, rs = RM.ssd_chunked(*map(jnp.asarray, (xh, dt, a, B_, C_)),
                            chunk=chunk, unroll=False,
                            init_state=None if init is None else
                            jnp.asarray(init))
    ty, ts = TM.ssd_chunked(*map(torch.from_numpy, (xh, dt, a, B_, C_)),
                            chunk=chunk,
                            init_state=None if init is None else
                            torch.from_numpy(init))
    assert ts.dtype == torch.float32
    _close(ty.numpy(), ry)
    _close(ts.numpy(), rs)


@pytest.mark.parametrize("t,chunk", [(300, 256), (513, 64), (300, 16)])
def test_ssd_chunked_against_the_recurrence(t, chunk):
    """The chunked form is the recurrence: within 1e-6 of a float64
    token-by-token evaluation (the reference reaches 3.7e-6 here)."""
    xh, dt, a, B_, C_, s0 = _ssd_inputs(3, t)
    dt = dt * 5  # long segments: large |log decay| sums within a chunk
    y64, s64 = _recurrence64(xh, dt, a, B_, C_, s0)
    ty, ts = TM.ssd_chunked(*map(torch.from_numpy, (xh, dt, a, B_, C_)),
                            chunk=chunk, init_state=torch.from_numpy(s0))
    _close(ty.numpy(), y64, 1e-6)
    _close(ts.numpy(), s64, 1e-6)


@pytest.mark.parametrize("t", [1, 2, 3, 9])
def test_causal_conv(t):
    """Without state (prefill: zero left padding) and with a carried
    (B, K-1, C) state (decode), which the window's last K-1 rows
    replace."""
    rng = np.random.default_rng(t)
    x = rng.normal(size=(2, t, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32)
    ry, _ = RM._causal_conv(*map(jnp.asarray, (x, w, b)))
    ty, tn = TM._causal_conv(*map(torch.from_numpy, (x, w, b)))
    assert tn is None
    _close(ty.numpy(), ry)
    ry, rn = RM._causal_conv(*map(jnp.asarray, (x, w, b)),
                             state=jnp.asarray(st))
    ty, tn = TM._causal_conv(*map(torch.from_numpy, (x, w, b)),
                             state=torch.from_numpy(st))
    _close(ty.numpy(), ry)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))


def test_gated_rmsnorm():
    rng = np.random.default_rng(4)
    y, z = (rng.normal(size=(2, 5, 64)).astype(np.float32) for _ in (0, 1))
    w = rng.normal(size=(64,)).astype(np.float32)
    _close(TM._gated_rmsnorm(*map(torch.from_numpy, (y, z, w))).numpy(),
           RM._gated_rmsnorm(*map(jnp.asarray, (y, z, w))))


def _block(arch="mamba2-2.7b"):
    cfg = get_config(arch).scaled_down()
    rp = jax.tree.map(np.asarray, init_from_defs(
        RM.mamba_defs(cfg), jax.random.key(1), jnp.float32))
    return cfg, rp, {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}


def test_mamba_defs_match():
    cfg = get_config("jamba-v0.1-52b").scaled_down()
    assert TM.mamba_dims(cfg) == RM.mamba_dims(cfg)
    r, t = RM.mamba_defs(cfg), TM.mamba_defs(cfg)
    assert {k: (v.shape, v.axes, v.init) for k, v in t.items()} == \
        {k: (v.shape, v.axes, v.init) for k, v in r.items()}


@pytest.mark.parametrize("t,chunk", [(2, 256), (12, 256), (40, 16)])
def test_mamba_block_prefill_then_decode(t, chunk):
    """Prefill (the conv state is the last K-1 raw inputs, left-padded
    below K-1 tokens), then the one-token recurrence for several steps
    from the carried states: output and both states each step."""
    cfg, rp, tp = _block()
    rng = np.random.default_rng(t)
    x = rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)
    ry, (rs, rc) = RM.mamba_block(cfg, jax.tree.map(jnp.asarray, rp),
                                  jnp.asarray(x), RPlan(), chunk=chunk)
    ty, (ts, tc) = TM.mamba_block(cfg, tp, torch.from_numpy(x), TPlan(),
                                  chunk=chunk)
    _close(ty.numpy(), ry)
    _close(ts.numpy(), rs)
    _close(tc.numpy(), rc)
    if t < cfg.ssm_conv - 1:
        assert not tc[:, :cfg.ssm_conv - 1 - t].any()  # left zero padding
    for step in range(DECODE_STEPS):
        x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        ry, (rs, rc) = RM.mamba_block(cfg, jax.tree.map(jnp.asarray, rp),
                                      jnp.asarray(x1), RPlan(),
                                      ssm_state=rs, conv_state=rc,
                                      decode=True)
        ty, (ts, tc) = TM.mamba_block(cfg, tp, torch.from_numpy(x1),
                                      TPlan(), ssm_state=ts,
                                      conv_state=tc, decode=True)
        _close(ty.numpy(), ry)
        _close(ts.numpy(), rs)
        _close(tc.numpy(), rc)


# ---- the families: ssm (mamba2) and hybrid (jamba) ----------------------
_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        cfg = get_config(arch).scaled_down()
        rp = R.init_params(cfg, jax.random.key(0), jnp.float32)
        _PARAMS[arch] = (cfg, rp, T.params_from_numpy(
            jax.tree.map(np.asarray, rp), device="cpu"))
    return _PARAMS[arch]


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape).astype(np.int32)


def _close_caches(tc, rc):
    assert set(tc) == set(rc)
    for lk in rc:
        assert set(tc[lk]) == set(rc[lk])
        for name in rc[lk]:
            assert tuple(tc[lk][name].shape) == rc[lk][name].shape
            assert str(tc[lk][name].dtype).split(".")[-1] == \
                str(rc[lk][name].dtype)
            _close(tc[lk][name].numpy(), rc[lk][name])


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_prefill_then_decode_carries_the_ssm_state(arch, impl):
    """``prefill`` and ``DECODE_STEPS`` ``decode_step``s: each step's
    logits and every cache leaf (k/v, ``ssm``, ``conv``) after each step.
    A decode that left the SSM states at their prefill values would fail
    from the first step on."""
    cfg, rp, tp = _params(arch)
    toks = _tokens(cfg, 2, (2, 12))
    rrt, trt = R.ModelRuntime(attn_impl=impl), T.ModelRuntime(
        attn_impl=impl)
    # the reference's step compiled once for the DECODE_STEPS calls
    r_step = jax.jit(lambda c, t, pos: R.decode_step(cfg, rp, c, t, pos,
                                                     RPlan(), rrt))
    rl, rc = R.prefill(cfg, rp, {"tokens": jnp.asarray(toks)}, RPlan(),
                       rrt, max_seq=24)
    tl, tc = T.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                       TPlan(), trt, max_seq=24)
    _close(tl.numpy(), rl)
    _close_caches(tc, rc)
    nxt = _tokens(cfg, 3, (DECODE_STEPS, 2, 1))
    for step in range(DECODE_STEPS):
        before = {lk: {n: v.clone() for n, v in leaf.items()}
                  for lk, leaf in tc.items() if "ssm" in leaf}
        rl, rc = r_step(rc, jnp.asarray(nxt[step]), 12 + step)
        tl, tc = T.decode_step(cfg, tp, tc, torch.from_numpy(nxt[step]),
                               12 + step, TPlan(), trt)
        _close(tl.numpy(), rl)
        _close_caches(tc, rc)
        for lk, leaf in before.items():
            assert not torch.equal(tc[lk]["ssm"], leaf["ssm"])
            assert not torch.equal(tc[lk]["conv"], leaf["conv"])


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_forward_train(arch, impl):
    """At the default SSD chunk (one chunk here) and at 8 (two, the
    second padded)."""
    cfg, rp, tp = _params(arch)
    toks = _tokens(cfg, 1, (2, 13))
    for chunk in (8, 256):
        want = R.forward_train(cfg, rp, {"tokens": jnp.asarray(toks)},
                               RPlan(), R.ModelRuntime(attn_impl=impl,
                                                       chunk=chunk))
        got = T.forward_train(cfg, tp, {"tokens": torch.from_numpy(toks)},
                              TPlan(), T.ModelRuntime(attn_impl=impl,
                                                      chunk=chunk))
        _close(got.numpy(), want)


def test_hybrid_layer_pattern():
    """Jamba's period of 8: attention at index 4, Mamba elsewhere, the
    MoE FFN at every odd index; the cache holds k/v only for the
    attention layer and f32 SSM states beside model-dtype conv windows."""
    from repro.models.blocks import layer_kinds as r_kinds
    from repro_torch.models.blocks import empty_cache, layer_kinds
    cfg = get_config("jamba-v0.1-52b")
    assert layer_kinds(cfg) == r_kinds(cfg)
    kinds = layer_kinds(cfg)
    assert [k["mixer"] for k in kinds].count("attn") == 1
    assert kinds[4]["mixer"] == "attn"
    assert [k["ffn"] for k in kinds] == ["dense", "moe"] * 4
    c = empty_cache(cfg.scaled_down(), 2, 16, torch.bfloat16, "meta")
    assert set(c["layer4"]) == {"k", "v"}
    assert c["layer0"]["ssm"].dtype == torch.float32
    assert c["layer0"]["conv"].dtype == torch.bfloat16
