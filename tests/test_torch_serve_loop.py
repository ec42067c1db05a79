"""The port's ``ServeLoop`` against the reference's, on the CPU.

Both loops serve the same requests on the same weights (the reference's
``init_params(..., jnp.float32)`` carried across as numpy), both with
the same ``attn_impl``: the reference's "flash" runs its Pallas kernel
in interpret mode, the port's its plain version.  The served tokens must
be identical.  The port decodes all slots in one batched step with a
position per slot where the reference vmaps a one-slot step; greedy
tokens are argmaxes over logits that agree to ~1e-5 (the models' parity
tests), so any difference in a token is a fault, not rounding, at these
seeds.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config
from repro.runtime import Request as RRequest
from repro.runtime import ServeLoop as RLoop
from repro_torch import models as T
from repro_torch.runtime import Request as TRequest
from repro_torch.runtime import ServeLoop as TLoop

CFG = get_config("tinyllama-1.1b").scaled_down(n_layers=2)
IMPLS = ["xla", "flash"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def _params(cfg=CFG):
    if cfg.name not in _PARAMS:
        rp = R.init_params(cfg, jax.random.key(0), jnp.float32)
        _PARAMS[cfg.name] = (rp, T.params_from_numpy(
            jax.tree.map(np.asarray, rp), device="cpu"))
    return _PARAMS[cfg.name]


def _prompts(seed, lens, vocab=CFG.vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve(impl, prompts, *, max_batch=2, max_seq=32, max_new=6,
           arrivals=None, cfg=CFG, **kw):
    """Serve ``prompts`` through both loops; returns (reference requests,
    port requests)."""
    rp, tp = _params(cfg)
    arrivals = arrivals or [0.0] * len(prompts)
    rl = RLoop(cfg, rp, max_batch=max_batch, max_seq=max_seq,
               rt=R.ModelRuntime(attn_impl=impl), **kw.get("ref", {}))
    tl = TLoop(cfg, tp, max_batch=max_batch, max_seq=max_seq,
               rt=T.ModelRuntime(attn_impl=impl), device="cpu",
               **kw.get("port", {}))
    out = []
    for loop, req in ((rl, RRequest), (tl, TRequest)):
        reqs = [req(rid=i, prompt=p.copy(), max_new_tokens=max_new,
                    arrival_s=a) for i, (p, a) in enumerate(zip(prompts,
                                                                arrivals))]
        loop.run(reqs, max_ticks=500)
        loop.close()
        out.append(reqs)
    return out


@pytest.mark.parametrize("impl", IMPLS)
def test_slots_reused(impl):
    """5 requests over 2 slots: every slot is reused, the tokens are the
    reference's."""
    ref, port = _serve(impl, _prompts(0, (5, 9, 17, 3, 12)))
    assert all(r.done for r in port)
    assert [len(r.tokens) for r in port] == [6] * 5
    assert [r.tokens for r in port] == [r.tokens for r in ref]


@pytest.mark.parametrize("impl", IMPLS)
def test_requests_reaching_the_cache_end(impl):
    """Prompts of max_seq - 2 and max_seq - 1 tokens stop at position
    max_seq - 1; the idle slot then sits at max_seq, past the cache (the
    reference's update clamps it, the port decodes it clamped), and the
    other slot's tokens are unaffected."""
    ref, port = _serve(impl, _prompts(1, (30, 31, 8, 4)), max_new=8)
    assert [len(r.tokens) for r in port] == [2, 2, 8, 8]
    assert [r.tokens for r in port] == [r.tokens for r in ref]


def test_serve_matches_offline_decode():
    """Continuous-batching output == straight prefill + argmax decode
    (the port's own functions), and == the reference's loop."""
    rp, tp = _params()
    prompt = _prompts(1, (7,))[0]
    plan = T.ShardingPlan()
    logits, cache = T.prefill(CFG, tp,
                              {"tokens": torch.from_numpy(prompt[None])},
                              plan, max_seq=32)
    want = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(3):
        lg, cache = T.decode_step(CFG, tp, cache,
                                  torch.tensor([[want[-1]]]), pos, plan)
        want.append(int(torch.argmax(lg[0, 0])))
        pos += 1
    loop = TLoop(CFG, tp, max_batch=2, max_seq=32, device="cpu")
    req = TRequest(rid=0, prompt=prompt, max_new_tokens=4)
    loop.run([req], max_ticks=50)
    assert req.tokens == want
    ref, _ = _serve("xla", [prompt], max_new=4)
    assert ref[0].tokens == want


def test_arrival_offsets_are_honoured():
    """Open-loop arrivals: a request is invisible before its offset, so
    the last arrival gates the run; tokens still the reference's."""
    t0 = time.perf_counter()
    ref, port = _serve("xla", _prompts(2, (4, 4, 4)), max_new=2,
                       arrivals=[0.0, 0.1, 0.2], max_seq=48)
    assert all(r.done for r in port)
    assert time.perf_counter() - t0 >= 0.4  # both loops waited
    assert [r.tokens for r in port] == [r.tokens for r in ref]


def test_encode_pixels_bridge():
    """Given the same tower features, both loops build the same vision
    prefix and trim the same text tokens."""
    rp, tp = _params()
    rng = np.random.default_rng(4)
    outs = {"conv1": rng.normal(size=(8, 6, 6)).astype(np.float32),
            "conv2": rng.normal(size=(8, 3, 3)).astype(np.float32)}
    for n in (5, 40):
        prompt = _prompts(5, (n,))[0]
        rq = RRequest(rid=0, prompt=prompt.copy(), max_new_tokens=6,
                      pixels=np.zeros((3, 8, 8), np.float32))
        tq = TRequest(rid=0, prompt=prompt.copy(), max_new_tokens=6,
                      pixels=np.zeros((3, 8, 8), np.float32))
        RLoop(CFG, rp, max_batch=1, max_seq=48)._encode_pixels(rq, outs)
        TLoop(CFG, tp, max_batch=1, max_seq=48,
              device="cpu")._encode_pixels(tq, outs)
        assert tq.pixels is None
        np.testing.assert_array_equal(tq.prompt, rq.prompt)


def test_vision_requests_through_the_scheduler():
    """Images through each loop's own ContinuousScheduler to its
    package's PlanServer (the port's on the CPU): the same vision
    prefixes and the same tokens."""
    from repro.core.costs import AnalyticCostModel as RCost
    from repro.serving import BucketPolicy as RPolicy
    from repro.serving import PlanServer as RServer
    from repro.serving import conv_tower as r_tower
    from repro_torch.core.costs import AnalyticCostModel as TCost
    from repro_torch.serving import BucketPolicy as TPolicy
    from repro_torch.serving import PlanServer as TServer
    from repro_torch.serving import conv_tower as t_tower
    rp, tp = _params()
    rng = np.random.default_rng(6)
    imgs = [rng.normal(size=(3, hw, hw)).astype(np.float32)
            for hw in (12, 20, 33)]
    prompts = _prompts(7, (6, 11, 9))
    rs = RServer(lambda s: r_tower(s, depth=2, width=8), RCost(),
                 policy=RPolicy(min_hw=8, max_hw=128), lru_capacity=4)
    ts = TServer(lambda s: t_tower(s, depth=2, width=8), TCost(),
                 policy=TPolicy(min_hw=8, max_hw=128), lru_capacity=4,
                 device="cpu")
    out = []
    for loop, req in ((RLoop(CFG, rp, max_batch=2, max_seq=48,
                             plan_server=rs), RRequest),
                      (TLoop(CFG, tp, max_batch=2, max_seq=48,
                             plan_server=ts, device="cpu"), TRequest)):
        reqs = [req(rid=i, prompt=p.copy(), max_new_tokens=4, pixels=x)
                for i, (p, x) in enumerate(zip(prompts, imgs))]
        try:
            loop.run(reqs, max_ticks=200)
        finally:
            loop.close()
        out.append(reqs)
    rs.close()
    ts.close()
    ref, port = out
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(b.prompt, a.prompt)
        assert b.tokens == a.tokens
    assert ts.stats()["requests"] == len(imgs)


def test_params_must_lie_on_the_loops_device():
    _, tp = _params()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLoop(CFG, tp)
    loop = TLoop(CFG, tp, device="cpu")
    assert loop.device.type == "cpu"
    assert loop.cache["layer0"]["k"].shape == (
        CFG.n_layers, 4, 128, CFG.n_kv_heads, CFG.resolved_head_dim)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mamba2-2.7b"])
def test_ssm_families_serve_the_reference_tokens(arch):
    """The hybrid (attention, Mamba and MoE layers) and the SSM family
    through both loops: 4 requests over 2 slots, so a freed slot's SSM
    state is overwritten by the next admission's prefill; the tokens
    are the reference's and each request's offline decode's."""
    cfg = get_config(arch).scaled_down()
    _, tp = _params(cfg)
    prompts = _prompts(8, (5, 11, 2, 7), vocab=cfg.vocab)
    ref, port = _serve("flash", prompts, max_new=5, cfg=cfg)
    assert all(r.done for r in port)
    assert [r.tokens for r in port] == [r.tokens for r in ref]
    plan = T.ShardingPlan()
    for r in port:
        logits, cache = T.prefill(cfg, tp, {"tokens": torch.from_numpy(
            r.prompt[None])}, plan, max_seq=32)
        want, pos = [int(torch.argmax(logits[0, -1]))], len(r.prompt)
        while len(want) < len(r.tokens):
            lg, cache = T.decode_step(cfg, tp, cache,
                                      torch.tensor([[want[-1]]]), pos, plan)
            want.append(int(torch.argmax(lg[0, 0])))
            pos += 1
        assert r.tokens == want, r.rid
