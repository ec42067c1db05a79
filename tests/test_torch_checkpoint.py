"""The port's checkpointer (``repro_torch.checkpoint``): the reference's
round trip, rotation and atomic-commit cases, and the same files as the
reference's, so that a checkpoint written by either package restores in
the other bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RCheckpointer
from repro.configs import get_config
from repro.models import init_params as r_init_params
from repro.optim import adamw as r_adamw
from repro_torch import tree as pytree
from repro_torch.checkpoint import Checkpointer
from repro_torch.models import init_params, params_from_numpy
from repro_torch.optim import adamw, warmup_cosine

CFG = get_config("tinyllama-1.1b").scaled_down(n_layers=2, d_model=64,
                                               d_ff=128, vocab=256)


def test_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = {"a": torch.arange(5, dtype=torch.float32),
            "b": {"c": torch.ones((2, 3), dtype=torch.bfloat16)}}
    ck.save(7, tree, extra={"loss": 1.5})
    step, restored, extra = ck.restore(tree)
    assert step == 7 and extra["loss"] == 1.5
    np.testing.assert_array_equal(restored["a"].numpy(), tree["a"].numpy())
    assert restored["b"]["c"].dtype == torch.bfloat16


def test_bf16_leaf_is_stored_as_f32_and_restored_exactly(tmp_path):
    """A bf16 leaf is ``a{i}__bf16`` in f32 (numpy has no bf16) and comes
    back with the same bits."""
    x = torch.randn(7, 5, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    ck = Checkpointer(tmp_path)
    ck.save(1, {"w": x, "n": torch.tensor(3, dtype=torch.int32)})
    with np.load(tmp_path / "step_1" / "arrays.npz") as data:
        assert sorted(data.files) == ["a0", "a1__bf16"]
        assert data["a1__bf16"].dtype == np.float32
        assert data["a0"].dtype == np.int32
    _, back, _ = ck.restore({"w": torch.zeros(7, 5, dtype=torch.bfloat16),
                             "n": torch.tensor(0, dtype=torch.int32)})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], x)
    assert back["n"].dtype == torch.int32 and int(back["n"]) == 3


def test_rotation_keeps_latest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    t = {"x": torch.zeros(3)}
    for s in [1, 2, 3, 4]:
        ck.save(s, t)
    assert ck.steps() == [3, 4]


def test_atomic_no_partial(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    t = {"x": torch.arange(4.0)}
    ck.save(1, t)
    # a stale tmp dir from a crashed writer must not break restore
    (tmp_path / "step_2.tmp").mkdir()
    assert ck.latest_step() == 1
    step, _, _ = ck.restore(t)
    assert step == 1
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(t)


def _ref_state():
    """The reference's ``(params, adamw state)`` after one update, so
    that m, v and count are not all zero."""
    params = r_init_params(CFG, jax.random.key(3), jnp.float32)
    opt = r_adamw(lambda s: 1e-3)
    state = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.cos(p * 7.0), params)
    return opt.update(grads, state, params)


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _same_bits(got, want):
    """Every leaf of the port's tree equal to the reference's, bit for
    bit, with its dtype."""
    flat_w, _ = jax.tree.flatten(want)
    flat_g = pytree.leaves(got)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_the_reference_writes_and_the_port_restores(tmp_path):
    params, state = _ref_state()
    RCheckpointer(tmp_path, keep=1).save(5, (params, state),
                                         extra={"loss": 2.5})
    like_p = init_params(CFG, 0, torch.float32, "cpu")
    like = (like_p, adamw(warmup_cosine(1e-3, 1, 2)).init(like_p))
    step, (tp, ts), extra = Checkpointer(tmp_path).restore(like)
    assert step == 5 and extra == {"loss": 2.5}
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 1
    _same_bits((tp, ts), (params, state))


def test_the_port_writes_and_the_reference_restores(tmp_path):
    params, state = _ref_state()
    Checkpointer(tmp_path, keep=1).save(
        9, (_to_torch(params), {"count": torch.tensor(1, dtype=torch.int32),
                                "m": _to_torch(state["m"]),
                                "v": _to_torch(state["v"])}),
        extra={"loss": 1.25})
    like = jax.tree.map(jnp.zeros_like, (params, state))
    step, back, extra = RCheckpointer(tmp_path).restore(like)
    assert step == 9 and extra == {"loss": 1.25}
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves((params, state))):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
