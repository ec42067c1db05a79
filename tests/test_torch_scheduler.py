"""The port's ContinuousScheduler + ElasticController, on the CPU: the
reference's ``tests/test_scheduler.py`` cases on the port's
``PlanServer(device="cpu")`` (the scheduler module is the reference's,
byte for byte; the server, the elastic controller and the serving loop
are the port's).

The scheduler's contract: requests coalesce continuously (window
trigger), SLO-carrying requests launch partial batches early (deadline
trigger), full groups launch immediately (full trigger), outputs are
bit-compatible with ``PlanServer.infer``, no submitted future is ever
lost (drain-on-close), and the elastic policy resizes the worker pool
deterministically from backlog pressure.
"""
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest

from repro_torch.core.costs import AnalyticCostModel
from repro_torch.runtime.elastic import ElasticController
from repro_torch.serving import (
    BucketPolicy, ContinuousScheduler, PlanServer, conv_tower,
)

CM = AnalyticCostModel()
POLICY = BucketPolicy(min_hw=8, max_hw=64, max_n=4)


def _server(**kw):
    kw.setdefault("policy", POLICY)
    kw.setdefault("lru_capacity", 8)
    kw.setdefault("device", "cpu")
    return PlanServer(lambda s: conv_tower(s, depth=2, width=4), CM, **kw)


def _sched(srv, **kw):
    kw.setdefault("batch_window_s", 0.05)
    kw.setdefault("elastic",
                  ElasticController(min_workers=1, max_workers=3))
    return ContinuousScheduler(srv, **kw)


class TestTriggers:
    def test_window_coalesces_burst_into_one_batch(self):
        srv = _server()
        sched = _sched(srv)
        sched.prewarm([(3, 16, 16)], batches=(1, 2))
        rng = np.random.default_rng(0)
        f1 = sched.submit(rng.normal(size=(3, 14, 14)).astype(np.float32))
        f2 = sched.submit(rng.normal(size=(3, 15, 15)).astype(np.float32))
        f1.result(timeout=60)
        f2.result(timeout=60)
        s = sched.stats()
        assert s["sched_batches"] == 1
        assert s["sched_window_launches"] == 1
        assert s["coalesced"] == 1          # 2 requests, 1 invocation
        sched.close()
        srv.close()

    def test_deadline_launches_partial_batch_early(self):
        srv = _server()
        sched = _sched(srv, batch_window_s=5.0)  # window out of play
        sched.prewarm([(3, 16, 16)], batches=(1,))
        x = np.zeros((3, 16, 16), np.float32)
        t0 = time.perf_counter()
        fut = sched.submit(x, slo_s=0.05)
        fut.result(timeout=60)
        dt = time.perf_counter() - t0
        s = sched.stats()
        assert s["sched_deadline_launches"] == 1
        assert dt < 1.0, f"deadline trigger never fired ({dt:.2f}s)"
        sched.close()
        srv.close()

    def test_full_group_launches_without_waiting(self):
        srv = _server()
        sched = _sched(srv, batch_window_s=10.0)  # window out of play
        sched.prewarm([(3, 16, 16)], batches=(POLICY.max_n,))
        x = np.zeros((3, 16, 16), np.float32)
        t0 = time.perf_counter()
        futs = sched.submit_many([x] * POLICY.max_n)
        for f in futs:
            f.result(timeout=60)
        dt = time.perf_counter() - t0
        s = sched.stats()
        assert s["sched_full_launches"] >= 1
        assert dt < 5.0, "full group waited for the window"
        sched.close()
        srv.close()

    def test_deadline_accounting_feeds_goodput(self):
        srv = _server()
        sched = _sched(srv, batch_window_s=0.005)
        sched.prewarm([(3, 16, 16)], batches=(1, 2))
        x = np.zeros((3, 16, 16), np.float32)
        sched.submit(x, slo_s=30.0).result(timeout=60)   # will be met
        sched.submit(x, slo_s=1e-9).result(timeout=60)   # already lapsed
        s = sched.stats()
        assert s["deadline_met"] == 1
        assert s["deadline_miss"] == 1
        assert s["goodput"] == pytest.approx(0.5)
        sched.close()
        srv.close()


class TestCorrectnessAndLifecycle:
    def test_outputs_match_infer(self):
        srv = _server()
        sched = _sched(srv, batch_window_s=0.005)
        rng = np.random.default_rng(3)
        xs = [rng.normal(size=(3, hw, hw)).astype(np.float32)
              for hw in (12, 16, 20)]
        refs = [srv.infer(x) for x in xs]
        outs = [f.result(timeout=120)
                for f in sched.submit_many(list(xs))]
        for ref, out in zip(refs, outs):
            assert set(out) == set(ref)
            for k in ref:
                np.testing.assert_allclose(out[k], ref[k],
                                           rtol=2e-3, atol=2e-3)
        sched.close()
        srv.close()

    def test_bad_input_rejected(self):
        srv = _server()
        sched = _sched(srv)
        with pytest.raises(ValueError, match=r"\(C, H, W\)"):
            sched.submit(np.zeros((16, 16), np.float32))
        sched.close()
        srv.close()

    def test_close_drains_queued_work(self):
        srv = _server()
        sched = _sched(srv, batch_window_s=30.0)  # nothing launches alone
        sched.prewarm([(3, 16, 16)], batches=(1, 2))
        futs = sched.submit_many(
            [np.zeros((3, 16, 16), np.float32)] * 2)
        sched.close(drain=True)
        for f in futs:
            assert f.result(timeout=1) is not None  # resolved, not hung
        srv.close()

    def test_close_without_drain_cancels(self):
        srv = _server()
        sched = _sched(srv, batch_window_s=30.0)
        sched.prewarm([(3, 16, 16)], batches=(1,))
        fut = sched.submit(np.zeros((3, 16, 16), np.float32))
        sched.close(drain=False)
        assert fut.cancelled()
        with pytest.raises(CancelledError):
            fut.result(timeout=1)
        srv.close()

    def test_submit_after_close_raises(self):
        srv = _server()
        sched = _sched(srv)
        sched.close()
        with pytest.raises(RuntimeError, match="closed"):
            sched.submit(np.zeros((3, 16, 16), np.float32))
        srv.close()

    def test_stats_expose_scheduler_view(self):
        srv = _server()
        sched = _sched(srv)
        s = sched.stats()
        for key in ("sched_queued", "sched_inflight", "sched_workers",
                    "sched_submits", "goodput"):
            assert key in s
        assert s["sched_queued"] == 0 and s["sched_inflight"] == 0
        assert s["goodput"] == 1.0  # no deadlines seen yet
        sched.close()
        srv.close()


class TestModeledLatency:
    def test_prediction_then_observation(self):
        """The latency model is predicted-until-measured: cost-model
        prediction for a cold bucket, per-bucket execute p95 once the
        bucket has real samples."""
        from repro_torch.serving import bucket_key
        from repro_torch.serving.metrics import LATENCY_METRIC

        srv = _server()
        sched = _sched(srv, min_model_samples=3)
        bshape = (4, 16, 16)
        cold = sched._modeled_latency(bshape, 1)
        assert np.isfinite(cold) and cold > 0
        assert cold == pytest.approx(
            max(float(srv.plan_for(bshape).predicted_cost), 1e-6))
        # feed 3 observed execute samples well away from the prediction
        for _ in range(3):
            srv.counters.add(_bucket=bucket_key(bshape, 1),
                             execute_s=0.25)
        h = srv.counters.registry.find_histogram(
            LATENCY_METRIC, phase="execute", bucket=bucket_key(bshape, 1))
        assert h is not None and h.count == 3
        warm = sched._modeled_latency(bshape, 1)
        assert warm == pytest.approx(0.25, rel=0.2)
        sched.close()
        srv.close()


class TestElasticPolicy:
    def test_scales_up_immediately_under_pressure(self):
        ec = ElasticController(min_workers=1, max_workers=4,
                               scale_up_backlog=2.0)
        assert ec.workers == 1
        g0 = ec.generation
        assert ec.desired_workers(queued=10, inflight=1) == 2
        assert ec.desired_workers(queued=10, inflight=2) == 3
        assert ec.generation == g0 + 2

    def test_scale_down_needs_sustained_calm(self):
        ec = ElasticController(min_workers=1, max_workers=4, cooldown=3,
                               scale_down_backlog=0.5)
        for _ in range(3):
            ec.desired_workers(queued=20, inflight=0)
        assert ec.workers == 4
        # two calm rounds: still 4 (cooldown is 3)
        assert ec.desired_workers(queued=0, inflight=0) == 4
        assert ec.desired_workers(queued=0, inflight=0) == 4
        # third consecutive calm round shrinks by one
        assert ec.desired_workers(queued=0, inflight=0) == 3
        # a load blip resets the calm streak
        ec.desired_workers(queued=0, inflight=0)
        ec.desired_workers(queued=20, inflight=0)        # blip (scales up)
        assert ec.desired_workers(queued=0, inflight=0) == 4
        assert ec.workers == 4                           # streak restarted

    def test_bounds_validated_and_respected(self):
        with pytest.raises(ValueError):
            ElasticController(min_workers=0)
        with pytest.raises(ValueError):
            ElasticController(min_workers=3, max_workers=2)
        ec = ElasticController(min_workers=2, max_workers=2)
        assert ec.desired_workers(queued=100, inflight=0) == 2
        for _ in range(10):
            assert ec.desired_workers(queued=0, inflight=0) == 2

    def test_scheduler_mirrors_target_into_server_pool(self):
        srv = _server(max_workers=2)
        sched = _sched(srv, batch_window_s=0.005,
                       elastic=ElasticController(min_workers=1,
                                                 max_workers=3))
        # construction applies the controller's initial target
        assert srv.worker_target == 1
        # a backlog burst must scale the pool up within a few rounds
        sched.prewarm([(3, 16, 16)], batches=(1, 2, 4))
        rng = np.random.default_rng(0)
        futs = sched.submit_many(
            [rng.normal(size=(3, 16, 16)).astype(np.float32)
             for _ in range(24)])
        for f in futs:
            f.result(timeout=120)
        s = sched.stats()
        assert s["worker_resizes"] >= 1
        assert srv.worker_target > 1
        sched.close()
        srv.close()


class TestServeLoopOpenLoop:
    def test_arrival_offsets_are_honoured(self):
        import torch
        from repro_torch.configs import get_config
        from repro_torch.models import init_params
        from repro_torch.runtime import Request, ServeLoop

        cfg = get_config("tinyllama-1.1b").scaled_down(
            n_layers=2, d_model=64, d_ff=128, vocab=256)
        params = init_params(cfg, 0, torch.float32, device="cpu")
        loop = ServeLoop(cfg, params, max_batch=2, max_seq=48,
                         device="cpu")
        reqs = [Request(rid=i, prompt=np.arange(4, dtype=np.int32),
                        max_new_tokens=2, arrival_s=0.1 * i)
                for i in range(3)]
        t0 = time.perf_counter()
        loop.run(reqs)
        wall = time.perf_counter() - t0
        assert all(r.done for r in reqs)
        assert wall >= 0.2  # the last arrival gated the run
        loop.close()


class TestWorkerDeath:
    """Injected worker-slot deaths mid-dispatch (PR 9 reliability)."""

    def _chaos_sched(self, plan: str):
        from repro_torch.reliability import FaultInjector, parse_fault_plan
        srv = _server(fault_injector=FaultInjector(parse_fault_plan(plan)))
        sched = ContinuousScheduler(srv, batch_window_s=0.01)
        sched.prewarm([(3, 16, 16)], batches=(1, 2))
        return srv, sched

    def test_death_requeues_group_and_completes(self):
        srv, sched = self._chaos_sched("worker:raise@0+1")
        x = np.random.default_rng(0).normal(size=(3, 16, 16)) \
            .astype(np.float32)
        healthy = srv.infer(x)
        out = sched.submit(x).result(timeout=60)
        s = sched.stats()
        assert s["worker_deaths"] == 1
        assert s["worker_requeues"] == 1
        for nid in healthy:
            np.testing.assert_allclose(out[nid], healthy[nid],
                                       rtol=1e-5, atol=1e-6)
        sched.close()
        srv.close()

    def test_second_death_poisons_the_request(self):
        from repro_torch.reliability import InjectedFault
        srv, sched = self._chaos_sched("worker:raise@0+2")
        x = np.zeros((3, 16, 16), np.float32)
        fut = sched.submit(x)
        with pytest.raises(InjectedFault):
            fut.result(timeout=60)
        s = sched.stats()
        assert s["worker_deaths"] == 2
        assert s["worker_requeues"] == 1  # requeued once, then poison
        sched.close()
        srv.close()

    def test_death_in_coalesced_group_requeues_all(self):
        srv, sched = self._chaos_sched("worker:raise@0+1")
        xs = [np.random.default_rng(i).normal(size=(3, 16, 16))
              .astype(np.float32) for i in range(2)]
        healthy = [srv.infer(x) for x in xs]
        futs = sched.submit_many(xs)
        outs = [f.result(timeout=60) for f in futs]
        s = sched.stats()
        assert s["worker_deaths"] >= 1
        assert s["worker_requeues"] >= 1
        for h, out in zip(healthy, outs):
            for nid in h:
                np.testing.assert_allclose(out[nid], h[nid],
                                           rtol=1e-5, atol=1e-6)
        sched.close()
        srv.close()


class TestLifecycleRaces:
    """close()/resize_workers() racing in-flight bucket groups."""

    def test_close_races_inflight_groups(self):
        # a burst across two buckets is still in flight when close()
        # lands; drain semantics say every submitted future resolves
        srv = _server()
        sched = ContinuousScheduler(srv, batch_window_s=0.002)
        sched.prewarm([(3, 16, 16), (3, 24, 24)], batches=(1, 2, 4))
        rng = np.random.default_rng(0)
        futs = [sched.submit(rng.normal(size=shape).astype(np.float32))
                for _ in range(8)
                for shape in ((3, 16, 16), (3, 24, 24))]
        sched.close()  # drain=True: must not strand any future
        assert all(f.done() for f in futs)
        for f in futs:
            out = f.result(timeout=0)
            assert all(np.isfinite(v).all() for v in out.values())
        srv.close()

    def test_resize_thrash_races_inflight_groups(self):
        # the worker pool is retargeted continuously while groups are
        # being dispatched; nothing may be lost or computed wrong
        import threading
        srv = _server()
        sched = ContinuousScheduler(srv, batch_window_s=0.002)
        sched.prewarm([(3, 16, 16)], batches=(1, 2, 4))
        stop = threading.Event()

        def thrash():
            n = 0
            while not stop.is_set():
                srv.resize_workers(1 + n % 4)
                n += 1
                time.sleep(0.001)

        t = threading.Thread(target=thrash, name="resize-thrash")
        t.start()
        try:
            x = np.random.default_rng(1).normal(size=(3, 16, 16)) \
                .astype(np.float32)
            healthy = srv.infer(x)
            futs = [sched.submit(x) for _ in range(24)]
            for f in futs:
                out = f.result(timeout=60)
                for nid in healthy:
                    np.testing.assert_allclose(out[nid], healthy[nid],
                                               rtol=1e-5, atol=1e-6)
        finally:
            stop.set()
            t.join(timeout=10)
        sched.close()
        srv.close()

    def test_worker_death_during_close_still_drains(self):
        # a group requeued by a dying worker after close() was called
        # must still be served by the drain, not stranded
        from repro_torch.reliability import FaultInjector, parse_fault_plan
        srv = _server(fault_injector=FaultInjector(
            parse_fault_plan("worker:raise@0+1")))
        sched = ContinuousScheduler(srv, batch_window_s=0.05)
        sched.prewarm([(3, 16, 16)])
        x = np.zeros((3, 16, 16), np.float32)
        fut = sched.submit(x)   # sits in the window when close() lands
        sched.close()
        out = fut.result(timeout=0)
        assert all(np.isfinite(v).all() for v in out.values())
        assert sched.stats()["worker_deaths"] == 1
        srv.close()
