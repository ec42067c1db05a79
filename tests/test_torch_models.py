"""The port's LM stack (``repro_torch.models``) against the reference's,
on the CPU.

The four dense configurations, ``scaled_down(n_layers=2)``, and the MoE,
encoder-decoder and VLM ones at ``scaled_down()`` (the SSM and hybrid
families are in ``test_torch_mamba.py``): the weights
are the reference's ``init_params(..., jnp.float32)``, carried across as
numpy (``params_from_numpy(..., device="cpu")``), and the token inputs
come from a numpy seed.  Each ``attn_impl`` is held against the
reference's same ``attn_impl``: the reference's "flash" runs its Pallas
kernel in interpret mode, as its own tests do, the port's its plain
version (the CUDA kernel's stand-in on the CPU).  At these lengths
"xla_chunked" takes the plain path in both packages, as it does below
T = 1024; the chunked form itself is held against the reference's at
T >= 1024 (``test_chunked_causal_attention`` and the model at T = 1024).

Tolerance: ``REL`` = 1e-4 of the reference's largest magnitude, for
the logits of ``forward_train``, ``prefill`` and ``decode_step`` and for
the caches.  Both packages compute in f32 and sum in other orders, and
the model amplifies that: the reference's initialisation draws the
stacked weights with a fan-in of the layer count (``sharding.py``'s
``shape[0]``), so at these widths the attention logits reach |s| ~ 260,
and the softmax turns an f32 rounding of s (~|s| x 6e-8) into a relative
error of ~1.5e-5 in its probabilities.  Measured on this file's
prefill and decode inputs: the reference's own f32 logits lie up to
1.7e-5 from a float64 evaluation of the same model (tinyllama's second
decode step; gemma2's third 1.4e-5), the port's up to 1.7e-5; the port
lies up to 2.5e-5 from the reference over this file's cases.  1e-5 is
not reachable by two f32 implementations here.

The encoder's frames and the VLM's patches are the reference's own test
inputs (``tests/test_models.py``): unit normals scaled by 0.02, the scale
of the encoder's position table.  The encoder-decoder is held to
``REL_ENCDEC`` = 3e-4: on this file's whisper inputs the reference's own
f32 logits lie up to 1.4e-4 from a float64 evaluation of the same model
(the port's up to 1.0e-4; forward_train at seeds 1, 2 and 5, both
``attn_impl``s), so two f32 implementations can lie twice that apart,
and do: up to 1.45e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import ARCHS, get_config
from repro.models import common as RC
from repro_torch import models as T
from repro_torch.models import common as TC
from repro_torch.models.sharding import PDef as TPDef

DENSE = ["tinyllama-1.1b", "mistral-nemo-12b", "command-r-35b", "gemma2-9b"]
#: the other families tested here, each at ``scaled_down()``
FAMILIES = ["kimi-k2-1t-a32b", "grok-1-314b", "whisper-large-v3",
            "llava-next-34b"]
IMPLS = ["xla", "flash", "xla_chunked"]
REL = 1e-4
REL_ENCDEC = 3e-4
B, T_PROMPT, MAX_SEQ, DECODE_STEPS = 2, 12, 24, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(cfg):
    return REL_ENCDEC if cfg.family == "encdec" else REL


def _cfg(arch):
    if arch in DENSE:
        return get_config(arch).scaled_down(n_layers=2)
    return get_config(arch).scaled_down()


_PARAMS = {}


def _params(arch):
    """(reference params, the port's copy on the CPU) for ``arch``."""
    if arch not in _PARAMS:
        rp = R.init_params(_cfg(arch), jax.random.key(0), jnp.float32)
        tp = T.params_from_numpy(jax.tree.map(np.asarray, rp),
                                 device="cpu")
        _PARAMS[arch] = (rp, tp)
    return _PARAMS[arch]


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape).astype(np.int32)


def _batches(cfg, seed, b, t):
    """The same batch for both packages: tokens, and the encoder's frames
    or the VLM's patches (unit normals x 0.02, as the reference's own
    tests make them)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(b, t)).astype(
        np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = (rng.normal(size=(b, cfg.enc_seq, cfg.d_model))
                           * 0.02).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = (rng.normal(size=(b, cfg.n_patches, cfg.d_model))
                            * 0.02).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= rel * scale, f"{err:.3e} > {rel} x {scale:.3e}"


def _shapes(defs):
    """A PDef tree of either package as {path: (shape, axes, init,
    scale)}."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], path + (k,))
        else:
            out[path] = (tuple(node.shape), tuple(node.axes), node.init,
                         node.scale)
    walk(defs, ())
    return out


# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_defs_match(arch):
    """The same parameter tree: paths, shapes, logical axes and
    initialisers, for every family."""
    cfg = _cfg(arch)
    assert _shapes(T.param_defs(cfg)) == _shapes(R.param_defs(cfg))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_at_full_size(arch):
    """Total and active (MoE: top_k of the experts) parameter counts."""
    cfg = get_config(arch)
    assert T.param_count(cfg) == R.param_count(cfg)
    assert T.active_param_count(cfg) == R.active_param_count(cfg)
    if cfg.n_experts:
        assert T.active_param_count(cfg) < T.param_count(cfg)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_pspecs_match(arch):
    """``Rules.spec`` resolves every parameter's logical axes to the
    reference's PartitionSpec, as a plain tuple."""
    cfg = _cfg(arch)
    want = jax.tree.leaves(R.param_pspecs(cfg, R.MEGATRON_RULES),
                           is_leaf=lambda x: isinstance(x, tuple))
    got = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            got.append(node)
    walk(T.param_pspecs(cfg, T.MEGATRON_RULES))
    assert [tuple(p) for p in want] == got


_CASES = ([(a, i) for a in DENSE for i in IMPLS]
          + [(a, i) for a in FAMILIES for i in ("xla", "flash")])


@pytest.mark.parametrize("arch,impl", _CASES)
def test_forward_train(arch, impl):
    """Logits over the label positions (a VLM's text positions)."""
    cfg = _cfg(arch)
    rp, tp = _params(arch)
    rb, tb = _batches(cfg, 1, B, 16)
    want = R.forward_train(cfg, rp, rb, R.ShardingPlan(),
                           R.ModelRuntime(attn_impl=impl))
    got = T.forward_train(cfg, tp, tb, T.ShardingPlan(),
                          T.ModelRuntime(attn_impl=impl))
    assert tuple(got.shape) == (B, 16, cfg.vocab)
    _close(got.numpy(), want, _rel(cfg))


@pytest.mark.parametrize("arch,impl", _CASES)
def test_prefill_and_decode(arch, impl):
    """``prefill``'s logits and cache, then three ``decode_step``s (an
    encoder-decoder's with the encoder's output as ``cross_kv``, a VLM's
    after its patches)."""
    cfg = _cfg(arch)
    rp, tp = _params(arch)
    rb, tb = _batches(cfg, 2, B, T_PROMPT)
    rrt, trt = R.ModelRuntime(attn_impl=impl), T.ModelRuntime(
        attn_impl=impl)
    off = cfg.n_patches if cfg.family == "vlm" else 0
    rl, rc = R.prefill(cfg, rp, rb, R.ShardingPlan(), rrt,
                       max_seq=MAX_SEQ + off)
    tl, tc = T.prefill(cfg, tp, tb, T.ShardingPlan(), trt,
                       max_seq=MAX_SEQ + off)
    _close(tl.numpy(), rl, _rel(cfg))
    rx = tx = None
    if cfg.family == "encdec":
        rx = R.encode(cfg, rp, rb["frames"], R.ShardingPlan(), rrt)
        tx = T.encode(cfg, tp, tb["frames"], T.ShardingPlan(), trt)
        _close(tx.numpy(), rx, _rel(cfg))
    assert set(tc) == set(rc)
    for lk in rc:
        for name in rc[lk]:
            assert tuple(tc[lk][name].shape) == rc[lk][name].shape
            _close(tc[lk][name].numpy(), rc[lk][name], _rel(cfg))
    nxt = _tokens(cfg, 3, (DECODE_STEPS, B, 1))
    pos = T_PROMPT + off
    for step in range(DECODE_STEPS):
        rl, rc = R.decode_step(cfg, rp, rc, jnp.asarray(nxt[step]), pos,
                               R.ShardingPlan(), rrt, cross_kv=rx)
        tl, tc = T.decode_step(cfg, tp, tc, torch.from_numpy(nxt[step]),
                               pos, T.ShardingPlan(), trt, cross_kv=tx)
        _close(tl.numpy(), rl, _rel(cfg))
        pos += 1
    for lk in rc:
        for name in rc[lk]:
            _close(tc[lk][name].numpy(), rc[lk][name], _rel(cfg))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-9b"])
def test_decode_with_a_position_per_row(arch):
    """One batched step with a position per row (the serving loop's
    slots) equals each row decoded alone at its own position: rope, the
    cache write and the mask are per row (gemma2: the sliding window)."""
    cfg = _cfg(arch)
    _, tp = _params(arch)
    toks = torch.from_numpy(_tokens(cfg, 4, (3, 20)).astype(np.int64))
    lens = [5, 20, 11]
    caches = [T.prefill(cfg, tp, {"tokens": toks[i:i + 1, :n]},
                        T.ShardingPlan(), max_seq=MAX_SEQ)[1]
              for i, n in enumerate(lens)]
    batched = {lk: {name: torch.cat([c[lk][name] for c in caches], dim=1)
                    for name in caches[0][lk]} for lk in caches[0]}
    nxt = torch.tensor([[7], [8], [9]])
    got, batched = T.decode_step(cfg, tp, batched, nxt,
                                 torch.tensor(lens), T.ShardingPlan())
    for i, n in enumerate(lens):
        want, c = T.decode_step(cfg, tp, caches[i], nxt[i:i + 1], n,
                                T.ShardingPlan())
        _close(got[i:i + 1].numpy(), want.numpy(), REL)
        for lk in c:
            for name in c[lk]:
                _close(batched[lk][name][:, i:i + 1].numpy(),
                       c[lk][name].numpy(), REL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_decode_past_the_sliding_window(impl):
    """gemma2 (scaled-down window 16): a 22-token prefill, then 6 decode
    steps at positions 22-27, past the window, then ``forward_train`` at
    T = 30, each against the reference at ``REL``."""
    cfg = _cfg("gemma2-9b")
    assert 0 < cfg.sliding_window < 22
    rp, tp = _params("gemma2-9b")
    toks = _tokens(cfg, 9, (B, 30))
    rrt, trt = R.ModelRuntime(attn_impl=impl), T.ModelRuntime(
        attn_impl=impl)
    rl, rc = R.prefill(cfg, rp, {"tokens": jnp.asarray(toks[:, :22])},
                       R.ShardingPlan(), rrt, max_seq=32)
    tl, tc = T.prefill(cfg, tp, {"tokens": torch.from_numpy(toks[:, :22])},
                       T.ShardingPlan(), trt, max_seq=32)
    _close(tl.numpy(), rl, REL)
    for pos in range(22, 28):
        nxt = toks[:, pos:pos + 1]
        rl, rc = R.decode_step(cfg, rp, rc, jnp.asarray(nxt), pos,
                               R.ShardingPlan(), rrt)
        tl, tc = T.decode_step(cfg, tp, tc, torch.from_numpy(nxt), pos,
                               T.ShardingPlan(), trt)
        _close(tl.numpy(), rl, REL)
    want = R.forward_train(cfg, rp, {"tokens": jnp.asarray(toks)},
                           R.ShardingPlan(), rrt)
    got = T.forward_train(cfg, tp, {"tokens": torch.from_numpy(toks)},
                          T.ShardingPlan(), trt)
    _close(got.numpy(), want, REL)


@pytest.mark.parametrize("t,chunk,softcap", [(1024, 0, 0.0),
                                              (1536, 0, 30.0),
                                              (2048, 512, 0.0)])
def test_chunked_causal_attention(t, chunk, softcap):
    """``attn_impl="xla_chunked"``'s attention, which ``attention`` takes
    only at T >= 1024 (the model tests above run below that), against the
    reference's on the same inputs: its own chunking (2 and 3 chunks) and
    a given one (4), with and without a softcap.  Unit-scale inputs keep
    the scores near 1, so 1e-5 of the largest magnitude holds here."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(1, t, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    kw = dict(scale=16 ** -0.5, softcap=softcap, chunk=chunk)
    want = RC.chunked_causal_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = TC.chunked_causal_attention(*map(torch.from_numpy, (q, k, v)),
                                      **kw)
    _close(got.numpy(), want, 1e-5)


def test_forward_train_takes_the_chunked_path(monkeypatch):
    """At T = 1024 a model with ``attn_impl="xla_chunked"`` runs the
    chunked form in every layer, and its logits are the reference's."""
    cfg = get_config("tinyllama-1.1b").scaled_down(
        n_layers=2, d_model=64, d_ff=128, vocab=256, n_heads=4,
        n_kv_heads=2, head_dim=16)
    rp = R.init_params(cfg, jax.random.key(0), jnp.float32)
    tp = T.params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    toks = _tokens(cfg, 8, (1, 1024))
    calls = []
    kept = TC.chunked_causal_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return kept(*a, **kw)
    monkeypatch.setattr(TC, "chunked_causal_attention", counted)
    rt = "xla_chunked"
    want = R.forward_train(cfg, rp, {"tokens": jnp.asarray(toks)},
                           R.ShardingPlan(), R.ModelRuntime(attn_impl=rt))
    got = T.forward_train(cfg, tp, {"tokens": torch.from_numpy(toks)},
                          T.ShardingPlan(), T.ModelRuntime(attn_impl=rt))
    assert len(calls) == cfg.n_layers
    _close(got.numpy(), want, REL)


def test_rope_at_long_positions():
    """Angles in f32 from f64-computed frequencies, as the reference's:
    at positions up to 2047 the rotation agrees within 1e-5."""
    x = np.random.default_rng(5).normal(size=(1, 2048, 4, 64)).astype(
        np.float32)
    pos = np.arange(2048, dtype=np.int32)[None]
    want = np.asarray(RC.rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    got = TC.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy()
    _close(got, want, REL)


@pytest.mark.parametrize("fn", ["rms_norm", "layer_norm"])
def test_norms(fn):
    rng = np.random.default_rng(6)
    x, w, b = (rng.normal(size=s).astype(np.float32)
               for s in ((3, 5, 64), (64,), (64,)))
    args = (x, w, b) if fn == "layer_norm" else (x, w)
    want = getattr(RC, fn)(*map(jnp.asarray, args))
    got = getattr(TC, fn)(*map(torch.from_numpy, args))
    _close(got.numpy(), want, REL)


def test_init_params_follow_the_reference_distributions():
    """The port draws its own values (a torch.Generator), from the
    reference's distributions: ones, and normal with std scale /
    sqrt(shape[0]); the same seed gives the same values."""
    cfg = _cfg("tinyllama-1.1b")
    a = T.init_params(cfg, 3, torch.float32, "cpu")
    b = T.init_params(cfg, 3, torch.float32, "cpu")
    c = T.init_params(cfg, 4, torch.float32, "cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["final_norm"], torch.ones(cfg.d_model))
    assert a["embed"].dtype == torch.float32
    for path, d in _shapes(T.param_defs(cfg)).items():
        leaf = a
        for k in path:
            leaf = leaf[k]
        assert tuple(leaf.shape) == d[0]
        if d[2] == "normal" and leaf.numel() > 1000:
            std = d[3] / np.sqrt(d[0][0])
            assert abs(float(leaf.std()) / std - 1) < 0.05, path
    assert T.init_params(cfg, 0, device="cpu")["embed"].dtype == \
        torch.bfloat16


def test_whisper_decode_with_cross_attention():
    """The reference's own check, on the port: prefill on the first six
    tokens and the frames, then a decode step with ``cross_kv =
    encode(...)``, against the full forward's logits at those positions
    and against the reference's step."""
    cfg = _cfg("whisper-large-v3")
    rp, tp = _params("whisper-large-v3")
    rb, tb = _batches(cfg, 5, 1, 8)
    plan, rt = T.ShardingPlan(), T.ModelRuntime()
    full = T.forward_train(cfg, tp, tb, plan, rt)
    enc = T.encode(cfg, tp, tb["frames"], plan, rt)
    logits, cache = T.prefill(cfg, tp, {"tokens": tb["tokens"][:, :6],
                                        "frames": tb["frames"]}, plan, rt,
                              max_seq=8)
    _close(logits[:, 0].numpy(), full[:, 5].numpy(), REL_ENCDEC)
    step, _ = T.decode_step(cfg, tp, cache, tb["tokens"][:, 6:7], 6, plan,
                            rt, cross_kv=enc)
    _close(step[:, 0].numpy(), full[:, 6].numpy(), REL_ENCDEC)
    _, rc = R.prefill(cfg, rp, {"tokens": rb["tokens"][:, :6],
                                "frames": rb["frames"]}, R.ShardingPlan(),
                      R.ModelRuntime(), max_seq=8)
    want, _ = R.decode_step(
        cfg, rp, rc, rb["tokens"][:, 6:7], 6, R.ShardingPlan(),
        R.ModelRuntime(), cross_kv=R.encode(cfg, rp, rb["frames"],
                                            R.ShardingPlan(),
                                            R.ModelRuntime()))
    _close(step.numpy(), want, REL_ENCDEC)


def test_vlm_label_offset():
    """The patches go ahead of the text; ``forward_train``'s logits are
    the text's only, and the last one is ``prefill``'s, whose cache
    holds patches and text."""
    cfg = _cfg("llava-next-34b")
    _, tp = _params("llava-next-34b")
    _, tb = _batches(cfg, 6, 1, 10)
    plan, rt = T.ShardingPlan(), T.ModelRuntime()
    h, pos, cross, off = T.model._prepare_inputs(cfg, tp, tb, plan, rt)
    assert off == cfg.n_patches and cross is None
    assert h.shape[1] == cfg.n_patches + 10 and pos.shape == (1, h.shape[1])
    full = T.forward_train(cfg, tp, tb, plan, rt)
    assert full.shape == (1, 10, cfg.vocab)
    last, cache = T.prefill(cfg, tp, tb, plan, rt, max_seq=4)
    _close(last[:, 0].numpy(), full[:, -1].numpy(), REL)
    assert cache["layer0"]["k"].shape[2] == cfg.n_patches + 10


def test_mesh_plans_resolve_to_placements():
    """A plan without a mesh keeps ``constrain`` the identity; with a
    named mesh it resolves specs to DTensor placements (mesh axes in the
    mesh's order) and refuses a mesh without names."""
    from torch.distributed.tensor import Replicate, Shard
    with pytest.raises(TypeError, match="DeviceMesh"):
        T.ShardingPlan(mesh=object())

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

        def size(self, i):
            return (2, 2, 4)[i]
    mp = T.ShardingPlan(mesh=Mesh())
    assert mp.placements((("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert mp.placements((None,)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        mp.placements((("data", "pod"),))
    plan = T.ShardingPlan()
    x = torch.ones(2, 3)
    assert plan.constrain(x, "batch", "d_model") is x
    assert T.MEGATRON_RULES.spec(("batch", "heads", None)) == \
        (("pod", "data"), "model", None)
    assert isinstance(TPDef((2,), ("d_model",)), TPDef)


def test_every_family_is_known():
    """Every registered architecture builds: its parameter tree, its
    parameters and its decode cache, at ``scaled_down()``."""
    fams = set()
    for arch, full in ARCHS.items():
        cfg = full.scaled_down()
        params = T.init_params(cfg, 0, torch.float32, "cpu")
        assert _shapes(T.param_defs(cfg)).keys() == _shapes(
            R.param_defs(cfg)).keys()
        assert params["embed"].shape == (cfg.vocab, cfg.d_model)
        cache = T.init_cache(cfg, 1, 8, torch.float32, "cpu")
        assert cache.keys() == R.init_cache(cfg, 1, 8, jnp.float32).keys()
        fams.add(cfg.family)
    assert fams == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
    assert dataclasses.is_dataclass(T.ModelRuntime())
