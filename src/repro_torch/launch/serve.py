"""Serving driver: continuous batching over a reduced model (port of the
reference's ``launch/serve.py``, with the same flags and output lines,
plus ``--device`` and ``--attn-impl``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --requests 8 --max-new 12
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --requests 6 --max-new 4 --vision-every 2

``--arch`` takes any architecture of ``repro_torch.configs``, served at
its ``scaled_down()`` size; the loop passes tokens only, as the
reference's does, so whisper and llava (which need frames or patches)
raise as they do there.

``--device`` (default ``cuda``) is the port's device idiom: the model,
its cache and the vision tower's executables live on the card unless
told otherwise, and the driver raises without one.  ``--attn-impl``
exposes ``ModelRuntime.attn_impl``: ``flash`` runs every prefill's
attention through the flash kernel (K6); the default, ``xla``, is the
plain path, as the reference's driver leaves it.

With ``--vision-every N`` every Nth request carries a random image that
is encoded into prompt tokens through the plan-cache serving subsystem
(bucketed PBQP selection + executable reuse, behind the continuous
scheduler); plan-cache hit/miss/latency counters are printed at the end.
``--plan-cache-dir`` persists the PBQP plans across runs.

``--profile <path>`` prices the PBQP selection from a measured
HardwareProfile (``python -m repro_torch.launch.calibrate``) instead of
the analytic model; ``--catalog <path>`` installs the surviving tuned
variants of a VariantCatalog (``python -m repro_torch.launch.tune``)
before the server solves, and the catalog's hash rotates every plan-cache
key.  ``--slo-ms`` attaches a deadline to every vision request (goodput
prints with the scheduler stats), ``--shed`` sheds requests whose SLO
the modeled backlog makes unmeetable, ``--arrival-rate`` replays the
request set as an open-loop Poisson process, ``--fault-plan`` injects
deterministic faults, ``--solve-deadline-ms`` bounds each PBQP solve.

Observability: ``--trace PATH`` writes one JSON line per span,
``--metrics-dump`` prints the plan server's Prometheus text exposition,
``--metrics-json PATH`` writes its stats snapshot.

``--mesh SPEC`` (``dp=2``, ``dp=2,tp=2``, ...; ``--dp-mesh N`` is the
shorthand for ``--mesh dp=N``) serves the vision tower's plans
mesh-sharded, as the reference's CLI does: the program runs on every
rank of a world of that many processes (``launch.mesh.run_spmd``; on one
card the ranks share it over gloo), each rank's plan server compiles
mesh executables (``PlanServer(mesh=)``), and rank 0 alone prints; the
``plan cache:`` line counts them (``mesh-sharded``).
"""
from __future__ import annotations

import argparse
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vision-every", type=int, default=0,
                    help="every Nth request carries an image (0: none)")
    ap.add_argument("--plan-cache-dir", default=None,
                    help="persist PBQP plans here (vision path)")
    ap.add_argument("--profile", default=None,
                    help="measured HardwareProfile JSON driving PBQP "
                         "selection (see repro_torch.launch.calibrate)")
    ap.add_argument("--catalog", default=None,
                    help="VariantCatalog JSON (repro_torch.launch.tune): "
                         "install its surviving tuned variants as "
                         "selectable primitives before serving; the "
                         "catalog hash rotates every plan-cache key")
    ap.add_argument("--image-tokens", type=int, default=4)
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="vision SLO in ms: image requests carry a "
                         "deadline and the continuous scheduler "
                         "launches partial batches before it lapses "
                         "(0: no deadline); goodput prints at the end")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate in req/s "
                         "(0: all requests queued up front)")
    ap.add_argument("--mesh", default=None, metavar="SPEC",
                    help="mesh-sharded vision serving: 'dp=2,tp=2' "
                         "(aliases dp/tp/pp or data/model/stage); the "
                         "program runs on that many ranks")
    ap.add_argument("--dp-mesh", type=int, default=0,
                    help="back-compat shorthand for --mesh dp=N")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write request-scoped trace spans as JSONL")
    ap.add_argument("--metrics-dump", action="store_true",
                    help="print the Prometheus text exposition of the "
                         "plan server's metrics registry at the end")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the plan server's stats snapshot as "
                         "JSON")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="chaos fault plan: a JSON file of fault specs or "
                         "an inline DSL like 'kernel:nan@5+3~winograd,"
                         "compile:raise@0+2'; faults fire "
                         "deterministically and degradations are "
                         "counted, not fatal")
    ap.add_argument("--solve-deadline-ms", type=float, default=0.0,
                    help="wall-clock budget per PBQP solve: branch-and-"
                         "bound becomes anytime and returns its best "
                         "incumbent at the deadline (0: exact, no "
                         "deadline)")
    ap.add_argument("--shed", action="store_true",
                    help="deadline-aware load shedding: reject vision "
                         "requests at admission when the modeled "
                         "backlog makes their SLO unmeetable (shed "
                         "images run unbatched instead; needs "
                         "--slo-ms)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the vision executables run "
                         "(default: the card; 'cpu' runs the plain "
                         "versions)")
    ap.add_argument("--attn-impl", default="xla",
                    choices=("xla", "xla_chunked", "flash"),
                    help="prefill attention: the plain path (xla, "
                         "xla_chunked) or the flash kernel (flash)")
    return ap


def _args(argv):
    """Parse and check ``argv``; returns (args, mesh spec or None)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.profile and args.vision_every <= 0:
        ap.error("--profile prices the vision plan path; it needs "
                 "--vision-every > 0 to have any effect")
    if args.catalog and args.vision_every <= 0:
        ap.error("--catalog extends the vision primitive registry; it "
                 "needs --vision-every > 0 to have any effect")
    if args.shed and (args.vision_every <= 0 or args.slo_ms <= 0):
        ap.error("--shed needs --vision-every > 0 and --slo-ms > 0 "
                 "(shedding is deadline-aware admission control)")
    if args.mesh and args.dp_mesh > 1:
        ap.error("--dp-mesh is the shorthand for --mesh dp=N; pass "
                 "one or the other")
    if args.dp_mesh > 1:
        args.mesh = f"dp={args.dp_mesh}"
    mesh_spec = None
    if args.mesh:
        if args.vision_every <= 0:
            ap.error("--mesh shards the vision plan path; it needs "
                     "--vision-every > 0 to have any effect")
        from .mesh import parse_mesh_spec
        try:
            mesh_spec = parse_mesh_spec(args.mesh)
        except ValueError as e:
            ap.error(str(e))
    return args, mesh_spec


def main(argv=None) -> int:
    args, mesh_spec = _args(argv)
    if mesh_spec is None:
        return _serve(args, None)
    from .mesh import run_spmd
    n = 1
    for s in mesh_spec[0]:
        n *= s
    # every rank runs the whole program; a rank that raises ends the
    # world with its traceback
    run_spmd(_serve_rank, n, args=(argv,), device=args.device,
             timeout_s=300.0)
    return 0


def _serve_rank(argv):
    """One rank of a ``--mesh`` run."""
    args, mesh_spec = _args(argv)
    return _serve(args, mesh_spec)


def _serve(args, mesh_spec) -> int:
    import numpy as np
    import torch

    from ..configs import get_config
    from ..kernels.common import resolve_device
    from ..models import ModelRuntime, init_params
    from ..runtime import Request, ServeLoop

    device = resolve_device(args.device)
    mesh = None
    if mesh_spec is not None:
        from .mesh import make_mesh
        mesh = make_mesh(*mesh_spec, device)
    import torch.distributed as dist
    lead = mesh is None or dist.get_rank() == 0
    import builtins
    print = builtins.print if lead else (lambda *a, **k: None)  # rank 0
    if args.trace and lead:
        from ..obs.trace import configure
        tracer = configure(args.trace, enabled=True)

    cfg = get_config(args.arch).scaled_down()
    params = init_params(cfg, args.seed, torch.float32, device)

    plan_server = cost_model = None
    if args.vision_every > 0:
        from ..core.costs import AnalyticCostModel
        from ..serving import BucketPolicy, PlanServer, conv_tower
        if args.catalog:
            from ..autotune import VariantCatalog
            catalog = VariantCatalog.load(args.catalog)
            n_inst = catalog.install()
            print(f"catalog {args.catalog}: installed {n_inst} "
                  f"tuned variants (content {catalog.content_hash()})")
        policy = BucketPolicy(min_hw=8, max_hw=128)
        cost_model = AnalyticCostModel()
        if args.profile:
            from ..calibrate import CalibratedCostModel, HardwareProfile
            cost_model = CalibratedCostModel(
                HardwareProfile.load(args.profile), fallback=cost_model,
                policy=policy, device=device)
        injector = None
        if args.fault_plan:
            from ..reliability import FaultInjector, parse_fault_plan
            injector = FaultInjector(parse_fault_plan(args.fault_plan),
                                     seed=args.seed)
        plan_server = PlanServer(
            lambda s: conv_tower(s, depth=2, width=8),
            cost_model,
            policy=policy, mesh=mesh,
            cache_dir=args.plan_cache_dir, lru_capacity=4,
            fault_injector=injector,
            solve_deadline_s=args.solve_deadline_ms / 1e3
            if args.solve_deadline_ms > 0 else None, device=device)

    slo_s = args.slo_ms / 1e3 if args.slo_ms > 0 else None
    scheduler = None
    if args.shed:
        from ..serving.scheduler import ContinuousScheduler
        scheduler = ContinuousScheduler(plan_server, slo_s=slo_s,
                                        shed=True)
    loop = ServeLoop(cfg, params, max_batch=args.max_batch,
                     max_seq=args.max_seq, plan_server=plan_server,
                     image_tokens=args.image_tokens,
                     scheduler=scheduler, slo_s=slo_s,
                     rt=ModelRuntime(attn_impl=args.attn_impl),
                     device=device)
    rng = np.random.default_rng(args.seed)
    reqs = []
    arrival = 0.0
    for i in range(args.requests):
        pixels = None
        if plan_server is not None and i % args.vision_every == 0:
            hw = int(rng.integers(12, 40))
            pixels = rng.normal(size=(3, hw, hw)).astype(np.float32)
        if args.arrival_rate > 0:
            # open-loop Poisson process: exponential interarrivals
            arrival += float(rng.exponential(1.0 / args.arrival_rate))
        reqs.append(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab,
                                size=int(rng.integers(4, 24)))
            .astype(np.int32),
            max_new_tokens=args.max_new, pixels=pixels,
            arrival_s=arrival))
    t0 = time.perf_counter()
    loop.run(reqs)
    dt = time.perf_counter() - t0
    tok = sum(len(r.tokens) for r in reqs)
    print(f"served {len(reqs)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok/dt:.1f} tok/s) on {device}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.tokens} "
              f"({r.latency_s*1e3:.0f} ms)")
    if plan_server is not None:
        s = loop.scheduler.stats() if loop.scheduler is not None \
            else plan_server.stats()
        if args.slo_ms > 0:
            print(f"scheduler: {s['sched_batches']} batches "
                  f"(full={s['sched_full_launches']} "
                  f"deadline={s['sched_deadline_launches']} "
                  f"window={s['sched_window_launches']})"
                  f" | goodput={s['goodput']:.2%}"
                  f" ({s['deadline_met']}/{s['deadline_met'] + s['deadline_miss']}"
                  f" deadlines met)"
                  f" | workers={s['sched_workers']}"
                  f" resizes={s['worker_resizes']}")
        print("plan cache: "
              f"{s['requests']} vision requests over {s['buckets']} buckets"
              f" | solves={s['solves']} (warm={s['warm_solves']})"
              f" compiles={s['compiles']}"
              f" | plan hits={s['plan_hits']} exec hits={s['exec_hits']}"
              f" | batched calls={s['batch_calls']}"
              f" (+{s['coalesced']} coalesced,"
              f" {s['mesh_compiles']} mesh-sharded)"
              f" | solve {s['solve_s']*1e3:.0f} ms"
              f" compile {s['compile_s']*1e3:.0f} ms"
              f" execute {s['execute_s']*1e3:.0f} ms")
        for phase, q in sorted(s.get("phases", {}).items()):
            print(f"  {phase}: n={q['count']} "
                  f"p50={q['p50']*1e3:.2f}ms p95={q['p95']*1e3:.2f}ms "
                  f"p99={q['p99']*1e3:.2f}ms")
        if s["ladder_demotions"] or s["quarantines"] or \
                s["shed_requests"] or s["plan_cache_corrupt"] or \
                s["worker_deaths"]:
            print("degradations: "
                  f"ladder exact={s['ladder_exact']} "
                  f"anytime={s['ladder_anytime']} "
                  f"greedy={s['ladder_greedy']} "
                  f"reference={s['ladder_reference']}"
                  f" | quarantines={s['quarantines']}"
                  f" (active: {', '.join(s['quarantined']) or 'none'})"
                  f" | shed={s['shed_requests']}"
                  f" corrupt plans={s['plan_cache_corrupt']}"
                  f" worker deaths={s['worker_deaths']}"
                  f" (requeued {s['worker_requeues']})"
                  f" | kernel failures={s['kernel_failures']}"
                  f" compile retries={s['compile_retries']}")
        if args.metrics_json and lead:
            import json
            with open(args.metrics_json, "w") as fh:
                json.dump(s, fh, indent=1, default=str)
            print(f"metrics snapshot written to {args.metrics_json}")
        if args.metrics_dump:
            print(plan_server.metrics_text(), end="")
        if args.profile:
            cov = cost_model.coverage()
            print(f"calibrated costs: {cov['table_hits']} table hits, "
                  f"{cov['fallback_hits']} analytic fallbacks "
                  f"({cov['table_rate']:.0%} measured)")
        loop.close()
        if scheduler is not None:
            scheduler.close()
        plan_server.close()
    if args.trace and lead:
        tracer.flush()
        print(f"trace spans written to {args.trace}")
    return 0


if __name__ == "__main__":
    from .mesh import stop_spmd
    try:
        rc = main()
    finally:
        stop_spmd()
    raise SystemExit(rc)
