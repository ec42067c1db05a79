"""The port's training path against the reference's, on the CPU: the
data pipeline, ``loss_fn`` and its gradients for every family, remat,
the fault-tolerant loop, and a whole run resumed from the reference's
step-0 checkpoint.

Weights are the reference's ``init_params(..., jnp.float32)`` carried
across as numpy; batches are the reference's ``make_batch`` (numpy draws
from the seed, the same in both packages).

Tolerances.  The loss within ``LOSS_REL`` = 1e-5 relative (measured: up
to 4.4e-7).  Each gradient leaf within ``GRAD_REL[arch]`` of that leaf's
largest reference magnitude: 1e-4, the LM parity tolerance of
``test_torch_models.py``, where two f32 evaluations can reach it, and
elsewhere twice the reference's own distance from float64.  The
reference's initialisation draws stacked weights with a fan-in of the
layer count (ROADMAP §3), so attention logits reach |s| ~ 100s and the
softmax amplifies f32 rounding; the backward pass amplifies it again.
Measured on this file's batch (seq 24, batch 2, ``scaled_down()``), the
worst leaf of the reference's f32 gradient lies from a float64
evaluation of the same model (the port with every f32 cast made f64):
tinyllama 7.1e-5, gemma2 1.7e-4, grok 8.7e-4, mamba2 9.1e-6, jamba
1.2e-3, whisper 3.8e-3, llava 5.8e-4; the port's f32 gradient from the
reference's: 2.0e-5, 1.6e-4, 4.7e-4, 1.0e-5, 9.4e-4, 3.4e-3, 3.4e-4.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import models as R
from repro.checkpoint import Checkpointer as RCheckpointer
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.data.pipeline import make_batch as r_make_batch
from repro.models.blocks import apply_superblock as r_apply_superblock
from repro.optim import adamw as r_adamw
from repro.optim import warmup_cosine as r_warmup_cosine
from repro.runtime import TrainLoopConfig as RTrainLoopConfig
from repro.runtime import train as r_train
from repro_torch import models as T
from repro_torch import tree as pytree
from repro_torch.data import SyntheticLM, make_batch
from repro_torch.models import model as t_model
from repro_torch.models.blocks import apply_superblock as t_apply_superblock
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime import (
    StragglerMonitor, TrainLoopConfig, TrainState, train,
)
from repro_torch.runtime.train_loop import loss_and_grads

LOSS_REL = 1e-5
#: every family: dense, dense with softcap and a sliding window, MoE,
#: SSM, hybrid, encoder-decoder, VLM; each with its gradient tolerance
#: (the module's docstring)
GRAD_REL = {"tinyllama-1.1b": 1e-4, "gemma2-9b": 4e-4, "grok-1-314b": 2e-3,
            "mamba2-2.7b": 1e-4, "jamba-v0.1-52b": 2.5e-3,
            "whisper-large-v3": 8e-3, "llava-next-34b": 1.2e-3}
ARCHS = list(GRAD_REL)
#: longer than gemma2's scaled-down window (16)
SHAPE = ShapeConfig("train_test", seq_len=24, global_batch=2, kind="train")

CFG = get_config("tinyllama-1.1b").scaled_down(n_layers=2, d_model=64,
                                               d_ff=128, vocab=256)
LOOP_SHAPE = ShapeConfig("tiny_train", seq_len=32, global_batch=4,
                         kind="train")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(pkg_adamw, pkg_warmup_cosine):
    return pkg_adamw(pkg_warmup_cosine(1e-3, 10, 200))


OPT = _opt(adamw, warmup_cosine)


def _batch(cfg, step=0, seed=0, shape=SHAPE):
    """The reference's batch, and the same as tensors on the CPU."""
    rb = r_make_batch(cfg, shape, step, seed=seed, dtype=jnp.float32)
    return rb, {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} x {scale:.3e}"


def _port_value_and_grad(cfg, params, batch, rt):
    loss, grads = loss_and_grads(cfg, T.ShardingPlan(), rt, params, batch)
    return loss, pytree.leaves(grads)


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        cfg = get_config(arch).scaled_down()
        rp = R.init_params(cfg, jax.random.key(0), jnp.float32)
        _PARAMS[arch] = (cfg, rp, T.params_from_numpy(
            jax.tree.map(np.asarray, rp), device="cpu"))
    return _PARAMS[arch]


# ----------------------------------------------------------------------
# the data pipeline
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-large-v3",
                                  "llava-next-34b"])
@pytest.mark.parametrize("step,seed", [(0, 0), (5, 1), (123, 7)])
def test_make_batch_is_the_references(arch, step, seed):
    """The same tokens, labels (int32), frames and patches (in the
    requested dtype) as the reference's, bit for bit."""
    cfg = get_config(arch).scaled_down()
    for rdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = r_make_batch(cfg, SHAPE, step, seed=seed, dtype=rdt)
        got = make_batch(cfg, SHAPE, step, seed=seed, dtype=tdt,
                         device="cpu")
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == (torch.int32 if k in ("tokens", "labels")
                                    else tdt), k
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k], np.float32))


def test_make_batch_labels_are_the_tokens_shifted():
    b = make_batch(CFG, LOOP_SHAPE, 0, device="cpu")
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    b2 = make_batch(CFG, LOOP_SHAPE, 1, device="cpu")
    assert not torch.equal(b["tokens"], b2["tokens"])
    it = iter(SyntheticLM(CFG, LOOP_SHAPE, seed=0, start_step=1,
                          device="cpu"))
    assert torch.equal(next(it)["tokens"], b2["tokens"])


# ----------------------------------------------------------------------
# the loss and its gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    cfg, rp, tp = _params(arch)
    rb, tb = _batch(cfg)
    want_loss, want_g = jax.value_and_grad(
        lambda p: R.loss_fn(cfg, p, rb, R.ShardingPlan(),
                            R.ModelRuntime()))(rp)
    loss, grads = _port_value_and_grad(cfg, tp, tb, T.ModelRuntime())
    assert abs(float(loss) - float(want_loss)) <= \
        LOSS_REL * abs(float(want_loss))
    flat_w, _ = jax.tree.flatten(want_g)
    assert len(grads) == len(flat_w)
    rel = GRAD_REL[arch]
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want_g)[0]]
    for path, g, w in zip(paths, grads, flat_w):
        _close(g.numpy(), w, rel, path)


def test_loss_masks_negative_labels():
    """Labels < 0 weigh nothing; the mean is over the others (and over
    one, not zero, when every label is masked)."""
    cfg, rp, tp = _params("tinyllama-1.1b")
    rb, tb = _batch(cfg)
    labels = np.asarray(rb["labels"]).copy()
    labels[0, :5] = -1
    labels[1, 3] = -100
    rb = {**rb, "labels": jnp.asarray(labels)}
    tb = {**tb, "labels": torch.from_numpy(labels)}
    want = R.loss_fn(cfg, rp, rb, R.ShardingPlan())
    got = T.loss_fn(cfg, tp, tb, T.ShardingPlan())
    assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))
    tb["labels"] = torch.full_like(tb["labels"], -1)
    assert float(T.loss_fn(cfg, tp, tb, T.ShardingPlan())) == 0.0


# ----------------------------------------------------------------------
# remat
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-v0.1-52b",
                                  "whisper-large-v3"])
def test_remat_policies_give_the_same_gradients(arch):
    """Remat changes what autograd keeps, not what is computed: the loss
    and every gradient without remat, under "full" and under "dots" are
    the same bits."""
    cfg, _, tp = _params(arch)
    _, tb = _batch(cfg)
    base_loss, base = _port_value_and_grad(cfg, tp, tb, T.ModelRuntime())
    for policy in ("full", "dots"):
        loss, grads = _port_value_and_grad(
            cfg, tp, tb, T.ModelRuntime(remat=True, remat_policy=policy))
        assert torch.equal(loss, base_loss), policy
        for g, b in zip(grads, base):
            assert torch.equal(g, b), policy


class _Products(TorchDispatchMode):
    """Records every matrix product dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            self.calls.append((func, args))
        return func(*args, **(kwargs or {}))


def _backward_products(cfg, tp, tb, rt):
    """The matrix products the backward pass of ``loss_fn`` runs: the
    gradients' and those remat recomputes."""
    leaves = [x.detach().requires_grad_() for x in pytree.leaves(tp)]
    loss = T.loss_fn(cfg, pytree.unflatten(tp, leaves), tb, T.ShardingPlan(),
                     rt)
    with _Products() as rec:
        torch.autograd.grad(loss, leaves)
    return rec.calls


def test_remat_recomputes_what_its_policy_drops():
    """Without remat the backward pass recomputes no product; under
    "full" it recomputes every product of the forward's superblocks but
    each one's last (the FFN's output, which no gradient reads: the
    recompute stops early), under "dots" only those with a batch
    dimension (attention's)."""
    from torch.utils.checkpoint import CheckpointPolicy
    cfg, _, tp = _params("tinyllama-1.1b")
    _, tb = _batch(cfg)
    with _Products() as fwd:
        with torch.no_grad():
            T.forward_train(cfg, tp, tb, T.ShardingPlan())
    head = 1    # the head's product, outside the superblocks
    batched = sum(t_model._dots_saveable(None, f, *a) !=
                  CheckpointPolicy.MUST_SAVE for f, a in fwd.calls)
    assert batched == 2 * cfg.n_layers       # scores and P V per layer
    none = len(_backward_products(cfg, tp, tb, T.ModelRuntime()))
    full = len(_backward_products(cfg, tp, tb, T.ModelRuntime(remat=True)))
    dots = len(_backward_products(cfg, tp, tb, T.ModelRuntime(
        remat=True, remat_policy="dots")))
    assert full - none == len(fwd.calls) - head - cfg.n_layers
    assert dots - none == batched


def _ref_dots(jaxpr):
    """(no batch dims, batched) counts of the dot_generals in a jaxpr,
    nested jaxprs included."""
    counts = [0, 0]
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (_, _), (lb, _) = eqn.params["dimension_numbers"]
            counts[1 if lb else 0] += 1
        for sub in jax.core.jaxprs_in_params(eqn.params):
            a, b = _ref_dots(sub)
            counts[0] += a
            counts[1] += b
    return counts


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-v0.1-52b",
                                  "grok-1-314b"])
def test_dots_policy_saves_the_references_products(arch):
    """The "dots" policy keeps the products the reference's
    ``dots_with_no_batch_dims_saveable`` keeps: in one superblock's
    forward, as many products saved (the port's ``mm``s and ``bmm``s of
    one batch entry, the reference's dot_generals without batch
    dimensions) as the reference.  The batched ones are recomputed in
    both; their counts differ where the two compute alike with other
    products (the SSD chunk's segment sums)."""
    from torch.utils.checkpoint import CheckpointPolicy
    cfg, rp, tp = _params(arch)
    h = np.random.default_rng(2).normal(
        size=(2, SHAPE.seq_len, cfg.d_model)).astype(np.float32)
    pos = np.arange(SHAPE.seq_len)[None]
    rblk = jax.tree.map(lambda x: x[0], rp["blocks"])
    jaxpr = jax.make_jaxpr(lambda h, p: r_apply_superblock(
        cfg, p, h, positions=jnp.asarray(pos),
        plan=R.ShardingPlan())[0])(jnp.asarray(h), rblk).jaxpr
    want = _ref_dots(jaxpr)
    tblk = t_model._unbind(tp["blocks"])[0]
    with _Products() as rec:
        t_apply_superblock(cfg, tblk, torch.from_numpy(h),
                           positions=torch.from_numpy(pos),
                           plan=T.ShardingPlan())
    saved = sum(t_model._dots_saveable(None, f, *a) ==
                CheckpointPolicy.MUST_SAVE for f, a in rec.calls)
    assert saved == want[0]
    assert len(rec.calls) - saved > 0 and want[1] > 0


# ----------------------------------------------------------------------
# K6 has no backward, as the reference's kernel has none
# ----------------------------------------------------------------------
def test_flash_attention_refuses_autograd():
    cfg, _, tp = _params("tinyllama-1.1b")
    _, tb = _batch(cfg)
    with pytest.raises(NotImplementedError, match="no backward"):
        _port_value_and_grad(cfg, tp, tb, T.ModelRuntime(attn_impl="flash"))
    # without an operand that requires grad (serving), or under no_grad,
    # it runs and agrees with the plain path
    flash = T.loss_fn(cfg, tp, tb, T.ShardingPlan(),
                      T.ModelRuntime(attn_impl="flash"))
    leaves = [x.detach().requires_grad_() for x in pytree.leaves(tp)]
    with torch.no_grad():
        plain = T.loss_fn(cfg, pytree.unflatten(tp, leaves), tb,
                          T.ShardingPlan(), T.ModelRuntime())
        again = T.loss_fn(cfg, pytree.unflatten(tp, leaves), tb,
                          T.ShardingPlan(), T.ModelRuntime(attn_impl="flash"))
    assert abs(float(flash) - float(plain)) <= LOSS_REL * float(plain)
    assert torch.equal(flash, again)


def test_training_with_flash_aborts(tmp_path):
    """Every step raises the refusal; the loop retries, then aborts."""
    with pytest.raises(RuntimeError, match="aborting") as err:
        train(CFG, LOOP_SHAPE, OPT, rt=T.ModelRuntime(attn_impl="flash"),
              loop=TrainLoopConfig(total_steps=3, ckpt_dir=str(tmp_path),
                                   max_retries=1, log_every=0),
              device="cpu")
    assert isinstance(err.value.__cause__, NotImplementedError)


# ----------------------------------------------------------------------
# the loop (the reference's tests/test_runtime.py cases, on the port)
# ----------------------------------------------------------------------
def _loop(tmp, **kw):
    kw.setdefault("log_every", 0)
    return TrainLoopConfig(ckpt_dir=str(tmp), **kw)


def test_loss_decreases(tmp_path):
    metrics = []
    train(CFG, LOOP_SHAPE, OPT, loop=_loop(tmp_path, total_steps=30,
                                          ckpt_every=10),
          metrics_out=metrics, device="cpu")
    first = np.mean([m["loss"] for m in metrics[:5]])
    last = np.mean([m["loss"] for m in metrics[-5:]])
    assert last < first, f"no learning: {first} -> {last}"


def test_restart_resumes_and_matches(tmp_path):
    """Train 30 straight vs 15 + restart + 15: the same losses
    (deterministic pipeline + checkpointed state)."""
    m_full, m1, m2 = [], [], []
    train(CFG, LOOP_SHAPE, OPT, loop=_loop(tmp_path / "a", total_steps=30,
                                          ckpt_every=15),
          metrics_out=m_full, device="cpu")
    train(CFG, LOOP_SHAPE, OPT, loop=_loop(tmp_path / "b", total_steps=15,
                                          ckpt_every=15),
          metrics_out=m1, device="cpu")
    st = train(CFG, LOOP_SHAPE, OPT, loop=_loop(tmp_path / "b",
                                               total_steps=30,
                                               ckpt_every=15),
               metrics_out=m2, device="cpu")
    assert isinstance(st, TrainState) and st.step == 30
    assert [m["step"] for m in m2] == list(range(15, 30))
    full_by_step = {m["step"]: m["loss"] for m in m_full}
    for m in m1 + m2:
        assert abs(m["loss"] - full_by_step[m["step"]]) < 1e-4, \
            f"divergence at step {m['step']} after restart"


def test_fault_injection_recovers(tmp_path):
    """Failures at steps 12 and 18: the loop restores from checkpoints
    and still finishes all 25 steps."""
    fails = {12, 18}

    def fault(step):
        if step in fails:
            fails.discard(step)
            raise RuntimeError(f"injected node failure @ {step}")

    metrics = []
    st = train(CFG, LOOP_SHAPE, OPT, loop=_loop(tmp_path, total_steps=25,
                                               ckpt_every=5),
               fault_hook=fault, metrics_out=metrics, device="cpu")
    assert st.step == 25
    assert not fails  # both faults actually fired
    assert max(m["step"] for m in metrics) == 24
    # steps 10-11 and 15-17 ran twice (replayed from steps 10 and 15)
    assert len(metrics) == 25 + 2 + 3


def test_persistent_failure_aborts(tmp_path):
    def always_fail(step):
        raise RuntimeError("dead node")

    with pytest.raises(RuntimeError, match="aborting"):
        train(CFG, LOOP_SHAPE, OPT, loop=_loop(tmp_path, total_steps=5,
                                              ckpt_every=2, max_retries=2),
              fault_hook=always_fail, device="cpu")


def test_a_failed_step_leaves_no_gradient(tmp_path):
    """A step that raises after the backward pass (a fault in the
    optimizer) leaves nothing in ``.grad`` and the state restored."""
    calls = []

    def update(grads, state, params):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected optimizer fault")
        return OPT.update(grads, state, params)
    opt = type(OPT)(OPT.init, update)
    metrics = []
    st = train(CFG, LOOP_SHAPE, opt, loop=_loop(tmp_path, total_steps=3,
                                               ckpt_every=1),
               metrics_out=metrics, device="cpu")
    assert st.step == 3 and [m["step"] for m in metrics] == [0, 1, 2]
    assert all(p.grad is None and not p.requires_grad
               for p in pytree.leaves(st.params))


def test_straggler_monitor_detects_slow_steps():
    mon = StragglerMonitor(factor=3.0)
    flags = [mon.observe(i, 0.1) for i in range(10)]
    assert not any(flags)
    assert mon.observe(10, 1.0)          # 10x slower
    assert mon.stragglers == [10]
    # EWMA not poisoned: a normal step right after is not flagged
    assert not mon.observe(11, 0.1)


def test_on_straggler_is_called(tmp_path, monkeypatch):
    """The loop feeds each step's time to the monitor and calls
    ``on_straggler`` for a slow one (a patched clock makes step 4
    slow)."""
    from types import SimpleNamespace

    from repro_torch.runtime import train_loop
    slow = {4}
    state = {"t": 0.0, "slow": False}

    def fake_clock():
        state["t"] += 10.0 if state["slow"] else 0.01
        return state["t"]

    def hook(step):
        state["slow"] = step in slow
    monkeypatch.setattr(train_loop, "time",
                        SimpleNamespace(perf_counter=fake_clock))
    seen = []
    train(CFG, LOOP_SHAPE, OPT, loop=_loop(tmp_path, total_steps=6,
                                          ckpt_every=6),
          fault_hook=hook, on_straggler=lambda s, dt: seen.append(s),
          device="cpu")
    assert seen == [4]


def test_the_cli_reports_a_run_with_no_step_left(tmp_path, capsys):
    """A second run of the CLI into the same ``--ckpt-dir`` resumes at
    ``--steps``, runs no step and says so."""
    from repro_torch.launch import train as train_cli
    argv = ["--steps", "2", "--d-model", "32", "--layers", "1", "--seq",
            "8", "--batch", "2", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    assert train_cli.main(argv) == 0
    assert "final loss" in capsys.readouterr().out
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("finished at step 2;") and \
        "no step run" in out[-1]


def test_default_checkpoint_dirs_lie_under_the_temporary_directory():
    """The loop's and the CLI's defaults honour ``TMPDIR`` and are the
    port's own, never the reference's ``/tmp/repro_ckpt``."""
    import os
    import tempfile

    from repro_torch.launch import train as train_cli
    tmp = tempfile.gettempdir()
    for d in (TrainLoopConfig().ckpt_dir,
              train_cli._parser().parse_args([]).ckpt_dir):
        assert os.path.dirname(d) == tmp
        assert os.path.basename(d).startswith("repro_torch_")


# ----------------------------------------------------------------------
# a whole run against the reference's, from one step-0 checkpoint
# ----------------------------------------------------------------------
def test_training_resumed_from_the_references_checkpoint(tmp_path):
    """The reference writes a step-0 checkpoint of its ``init_params`` and
    AdamW state; both packages' ``train`` resume from copies of it for 5
    steps: the same losses within 1e-4."""
    rp = R.init_params(CFG, jax.random.key(0), jnp.float32)
    ropt = _opt(r_adamw, r_warmup_cosine)
    RCheckpointer(tmp_path / "ref", keep=3).save(0, (rp, ropt.init(rp)))
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    want, got = [], []
    r_train(CFG, LOOP_SHAPE, ropt,
            loop=RTrainLoopConfig(total_steps=5, ckpt_every=5,
                                  ckpt_dir=str(tmp_path / "ref"),
                                  log_every=0),
            metrics_out=want)
    train(CFG, LOOP_SHAPE, OPT, loop=_loop(tmp_path / "port", total_steps=5,
                                          ckpt_every=5),
          metrics_out=got, device="cpu")
    assert [m["step"] for m in got] == [m["step"] for m in want] == \
        list(range(5))
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) < 1e-4, (g, w)
