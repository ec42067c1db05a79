"""The port's MoE FFN (``repro_torch.models.moe``) against the
reference's, on the CPU.

Weights are the reference's ``init_from_defs(moe_defs(cfg), ...,
jnp.float32)`` carried across as numpy; inputs come from a numpy seed.
Tolerance: ``REL`` = 1e-4 of the reference's largest magnitude, as in
``test_torch_models.py``.  The routing itself (each pair's expert, rank,
destination row and whether it is kept) must be identical; the gates
agree within ``REL``.  ``torch.topk`` and ``jax.lax.top_k`` may order
tied experts differently, so the test that builds ties compares the set
of chosen experts per token.

The batched decode: the reference's serving loop decodes one slot at a
time, where a capacity of at least 8 rows never drops a pair; the port's
loop decodes every slot in one step and asks that step for a capacity of
at least its token count (``decode_step(..., drop_free=True)``).  A
router that sends every token to the same two experts, at 16 slots,
would overflow ``capacity(cfg, 16)`` = 8 rows; the loop's batched step
must still be the reference's one-slot decode, row for row.  Without
``drop_free``, ``decode_step`` keeps the reference's capacity and drops
the same pairs as the reference's ``decode_step`` on the same batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as R
from repro.configs import get_config
from repro.models import moe as RM
from repro.models.sharding import ShardingPlan as RPlan
from repro.models.sharding import init_from_defs
from repro_torch import models as T
from repro_torch.models import moe as TM
from repro_torch.models.sharding import ShardingPlan as TPlan

REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(e=4, k=2, cf=4.0, arch="grok-1-314b"):
    return get_config(arch).scaled_down(
        n_layers=2, d_model=32, d_ff=64, vocab=256, n_experts=e, top_k=k,
        capacity_factor=cf)


def _params(cfg, seed=0):
    rp = init_from_defs(RM.moe_defs(cfg), jax.random.key(seed),
                        jnp.float32)
    return rp, {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= rel * scale, f"{err:.3e} > {rel} x {scale:.3e}"


def _x(seed, shape, d):
    return np.random.default_rng(seed).normal(size=shape + (d,)).astype(
        np.float32)


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (6, 3), (4, 1)])
@pytest.mark.parametrize("n", [1, 7, 64])
def test_capacity(e, k, n):
    for cf in (0.5, 1.25, 4.0):
        cfg = _cfg(e=e, k=k, cf=cf)
        assert TM.capacity(cfg, n) == RM.capacity(cfg, n)


def test_moe_defs_match():
    cfg = _cfg()
    r, t = RM.moe_defs(cfg), TM.moe_defs(cfg)
    assert {k: (v.shape, v.axes, v.init) for k, v in t.items()} == \
        {k: (v.shape, v.axes, v.init) for k, v in r.items()}


@pytest.mark.parametrize("cf", [4.0, 1.25, 0.5])
@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (6, 3)])
def test_moe_ffn(e, k, cf):
    """Drop-free (cf 4) and with drops (cf 1.25 and 0.5): the same kept
    set and the same output."""
    cfg = _cfg(e=e, k=k, cf=cf)
    rp, tp = _params(cfg, seed=e + k)
    x = _x(1, (2, 16), cfg.d_model)
    want = RM.moe_ffn(cfg, rp, jnp.asarray(x), RPlan())
    got = TM.moe_ffn(cfg, tp, torch.from_numpy(x), TPlan())
    _close(got.numpy(), want)
    c = RM.capacity(cfg, 32)
    _, (rkeep, rdest, rsrc, rgate) = RM._local_dispatch(
        cfg, rp, jnp.asarray(x.reshape(32, -1)), c)
    _, (tkeep, tdest, tsrc, tgate) = TM._local_dispatch(
        cfg, tp, torch.from_numpy(x.reshape(32, -1)), c)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(rkeep))
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(rdest))
    np.testing.assert_array_equal(tsrc.numpy(), np.asarray(rsrc))
    _close(tgate.numpy(), rgate)
    if cf == 0.5:
        assert not tkeep.all()  # this case does drop pairs
    if cf == 4.0:
        assert tkeep.all()


def test_dispatch_buffer_and_gate_renormalisation():
    """The (E, C, D) buffer holds each kept pair's token at its expert's
    rank; each token's gates sum to 1 over its top-k, before any drop."""
    cfg = _cfg(e=4, k=2, cf=0.5)
    rp, tp = _params(cfg, seed=3)
    xf = _x(2, (24,), cfg.d_model)
    c = RM.capacity(cfg, 24)
    rbuf, _ = RM._local_dispatch(cfg, rp, jnp.asarray(xf), c)
    tbuf, (keep, dest, src, gate) = TM._local_dispatch(
        cfg, tp, torch.from_numpy(xf), c)
    assert tuple(tbuf.shape) == (cfg.n_experts, c, cfg.d_model)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(rbuf))
    per_token = torch.zeros(24, dtype=torch.float32).index_add_(0, src,
                                                                gate)
    np.testing.assert_allclose(per_token.numpy(), 1.0, rtol=1e-6)
    assert not keep.all()


def test_aux_load_balance_loss():
    cfg = _cfg(e=8, k=2)
    logits = np.random.default_rng(4).normal(size=(2, 16, 8)).astype(
        np.float32) * 3
    want = RM.aux_load_balance_loss(cfg, jnp.asarray(logits))
    got = TM.aux_load_balance_loss(cfg, torch.from_numpy(logits))
    _close(got.numpy(), want, 1e-6)


def test_tied_experts_choose_the_same_set():
    """Two identical router columns that every (positive) token prefers:
    each token chooses both tied experts, in whichever order, and the
    output is the reference's."""
    cfg = _cfg(e=4, k=2, cf=4.0)
    rp, _ = _params(cfg, seed=5)
    router = -np.ones((cfg.d_model, 4), np.float32)
    router[:, 2] = router[:, 3] = 1.0
    rp = {**rp, "router": jnp.asarray(router)}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    x = np.abs(_x(6, (1, 12), cfg.d_model))
    want = RM.moe_ffn(cfg, rp, jnp.asarray(x), RPlan())
    got = TM.moe_ffn(cfg, tp, torch.from_numpy(x), TPlan())
    _close(got.numpy(), want)
    probs = torch.softmax(torch.from_numpy(x[0]) @ torch.from_numpy(router),
                          dim=-1)
    t_idx = torch.topk(probs, 2).indices.numpy()
    r_idx = np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1])
    assert [set(r) for r in t_idx] == [set(r) for r in r_idx] == \
        [{2, 3}] * 12


def test_drop_free_capacity():
    """``drop_free`` raises the capacity to the token count: no pair is
    dropped even when every token picks the same experts."""
    cfg = _cfg(e=8, k=2, cf=1.25)
    _, tp = _params(cfg, seed=7)
    router = np.zeros((cfg.d_model, 8), np.float32)
    router[:, 0], router[:, 1] = 2.0, 1.0
    router[:, 2:] = -1.0
    tp = {**tp, "router": torch.from_numpy(router)}
    x = torch.from_numpy(np.abs(_x(8, (16, 1), cfg.d_model)))
    assert TM.capacity(cfg, 16) < 16
    _, (keep, _, _, _) = TM._local_dispatch(cfg, tp, x.reshape(16, -1),
                                            TM.capacity(cfg, 16))
    assert not keep.all()
    y_free = TM.moe_ffn(cfg, tp, x, TPlan(), drop_free=True)
    # row by row, one token at a time (never drops): the same output
    rows = torch.cat([TM.moe_ffn(cfg, tp, x[i:i + 1], TPlan())
                      for i in range(16)])
    _close(y_free.numpy(), rows.numpy(), 1e-6)


def _two_expert_model():
    """A scaled-down grok whose routers send every token to experts 0
    and 1 (a large embedding component that the routers read): the
    reference's and the port's parameters."""
    cfg = get_config("grok-1-314b").scaled_down(
        n_layers=2, n_experts=8, capacity_factor=1.25)
    rp = jax.tree.map(np.array, R.init_params(cfg, jax.random.key(0),
                                              jnp.float32))
    rp["embed"][:, 0] += 1000.0
    for lk in rp["blocks"]:
        router = np.zeros_like(rp["blocks"][lk]["moe"]["router"])
        router[:, 0, :] = [4.0, 2.0] + [-4.0] * 6
        rp["blocks"][lk]["moe"]["router"] = router
    tp = T.params_from_numpy(rp, device="cpu")
    return cfg, jax.tree.map(jnp.asarray, rp), tp


class _Dispatches:
    """Inside ``with``: (tokens, capacity, keep, expert) of every MoE
    dispatch of the port."""

    def __enter__(self):
        self.seen, self._kept = [], TM._local_dispatch

        def spy(cfg_, p, xf, c):
            out = self._kept(cfg_, p, xf, c)
            self.seen.append((xf.shape[0], c, out[1][0], out[1][1] // c))
            return out
        TM._local_dispatch = spy
        return self

    def __exit__(self, *exc):
        TM._local_dispatch = self._kept


def test_batched_decode_matches_the_per_slot_reference():
    """16 slots decoded in one batched step as the serving loop decodes
    them (``drop_free``), every token routed to the same two experts,
    against the reference's decode of each slot alone."""
    cfg, rp, tp = _two_expert_model()
    slots, max_seq = 16, 24
    rng = np.random.default_rng(9)
    lens = np.array([5, 11] * (slots // 2))  # two prompt shapes to trace
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in lens]
    nxt = rng.integers(0, cfg.vocab, size=(slots, 1)).astype(np.int32)
    caches = [T.prefill(cfg, tp, {"tokens": torch.from_numpy(p[None])},
                        T.ShardingPlan(), max_seq=max_seq)[1]
              for p in prompts]
    batched = {lk: {n: torch.cat([c[lk][n] for c in caches], dim=1)
                    for n in caches[0][lk]} for lk in caches[0]}
    with _Dispatches() as d:
        got, _ = T.decode_step(cfg, tp, batched, torch.from_numpy(nxt)
                               .long(), torch.from_numpy(lens),
                               T.ShardingPlan(), drop_free=True)
    assert d.seen and all(n == slots for n, *_ in d.seen)
    for n, c, keep, expert in d.seen:
        # both experts take all 16 tokens: more than capacity(cfg, 16)
        assert sorted(set(expert.tolist())) == [0, 1]
        assert TM.capacity(cfg, n) < slots <= c and bool(keep.all())
    # the reference's one-slot prefill and decode, each compiled once
    r_prefill = jax.jit(lambda t: R.prefill(
        cfg, rp, {"tokens": t}, R.ShardingPlan(), max_seq=max_seq)[1])
    r_decode = jax.jit(lambda c, t, pos: R.decode_step(
        cfg, rp, c, t, pos, R.ShardingPlan())[0])
    for i, p in enumerate(prompts):
        want = r_decode(r_prefill(jnp.asarray(p[None])),
                        jnp.asarray(nxt[i:i + 1]), int(lens[i]))
        _close(got[i:i + 1].numpy(), want)


def test_batched_decode_step_drops_as_the_reference_does():
    """``decode_step`` at 16 rows without ``drop_free`` keeps the
    reference's ``capacity(cfg, 16)`` = 8 rows: with every token routed
    to the same two experts both drop the same pairs, and the logits
    agree with the reference's ``decode_step`` on the same batch.  With
    ``drop_free`` the port drops nothing and its logits differ."""
    cfg, rp, tp = _two_expert_model()
    rows, t, max_seq = 16, 5, 8
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, size=(rows, t)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, size=(rows, 1)).astype(np.int32)
    _, rc = R.prefill(cfg, rp, {"tokens": jnp.asarray(prompt)},
                      R.ShardingPlan(), max_seq=max_seq)
    want = R.decode_step(cfg, rp, rc, jnp.asarray(nxt), t,
                         R.ShardingPlan())[0]
    _, tc = T.prefill(cfg, tp, {"tokens": torch.from_numpy(prompt).long()},
                      T.ShardingPlan(), max_seq=max_seq)
    tc_free = {lk: {n: v.clone() for n, v in leaf.items()}
               for lk, leaf in tc.items()}
    with _Dispatches() as d:
        got, _ = T.decode_step(cfg, tp, tc, torch.from_numpy(nxt).long(), t,
                               T.ShardingPlan())
    assert d.seen and all(n == rows and c == TM.capacity(cfg, rows) < rows
                          and not bool(keep.all())
                          for n, c, keep, _ in d.seen)
    _close(got.numpy(), want)
    free, _ = T.decode_step(cfg, tp, tc_free, torch.from_numpy(nxt).long(),
                            t, T.ShardingPlan(), drop_free=True)
    want = np.asarray(want)
    assert np.abs(free.numpy() - want).max() > REL * np.abs(want).max()


def test_serve_loop_at_16_slots_drops_no_pair():
    """The port's ``ServeLoop`` with 16 slots over the two-expert model:
    every decode tick's dispatch keeps every pair (the loop asks its
    batched step for ``drop_free``), and the served tokens are the
    reference loop's, which decodes each slot alone."""
    from repro.runtime import Request as RRequest
    from repro.runtime import ServeLoop as RLoop
    from repro_torch.runtime import Request as TRequest
    from repro_torch.runtime import ServeLoop as TLoop
    cfg, rp, tp = _two_expert_model()
    slots, t, max_new = 16, 6, 3
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab, size=(slots, t)).astype(np.int32)
    out = []
    for loop, req in ((RLoop(cfg, rp, max_batch=slots, max_seq=16), RRequest),
                      (TLoop(cfg, tp, max_batch=slots, max_seq=16,
                             device="cpu"), TRequest)):
        reqs = [req(rid=i, prompt=p.copy(), max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        with _Dispatches() as d:
            loop.run(reqs, max_ticks=50)
        loop.close()
        out.append((reqs, d.seen))
    (ref, _), (port, seen) = out
    ticks = [(c, keep) for n, c, keep, _ in seen if n == slots]
    assert len(ticks) == cfg.n_layers * (max_new - 1)
    assert all(c >= slots and bool(keep.all()) for c, keep in ticks)
    assert all(r.done for r in port)
    assert [r.tokens for r in port] == [r.tokens for r in ref]
