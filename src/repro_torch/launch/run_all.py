"""Fan out the full (arch x shape x mesh) dry-run matrix as subprocesses.

Port of the reference's ``launch/run_all.py``.  Each cell runs in its
own process (fault isolation, a fresh fake process group); results land
in ``build/repro_torch/dryrun/*.json`` (git-ignored) unless ``--out``
says otherwise.  Skipped cells (long_500k on pure full-attention archs)
get a marker artifact.  Needs no card: the dry-run traces meta tensors.

  PYTHONPATH=src python -m repro_torch.launch.run_all [--jobs 3] [--force]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

from ..configs import cells
from .dryrun import ARTIFACT_DIR, cell_name


def _run_one(arch, shape, multi_pod, out_dir, timeout=3600):
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", str(out_dir)]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ)
    src = str(pathlib.Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
        ok = proc.returncode == 0
        err = proc.stderr[-2000:] if not ok else ""
    except subprocess.TimeoutExpired:
        ok, err = False, f"timeout after {timeout}s"
    return arch, shape, mesh_tag, ok, time.time() - t0, err


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    ap.add_argument("--meshes", default="both",
                    choices=["both", "single", "multi"])
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    meshes = {"both": [False, True], "single": [False],
              "multi": [True]}[args.meshes]
    work = []
    for arch, shape, skip in cells():
        for mp in meshes:
            tag = "2x16x16" if mp else "16x16"
            path = out_dir / f"{cell_name(arch, shape, mp)}.json"
            if skip:
                path.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": tag,
                    "status": "skipped", "reason": skip}, indent=2))
                continue
            if path.exists() and not args.force:
                rec = json.loads(path.read_text())
                if rec.get("status") == "ok":
                    continue
            work.append((arch, shape, mp))

    print(f"{len(work)} cells to run on {args.jobs} workers", flush=True)
    t0 = time.time()
    fails = []
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        futs = {ex.submit(_run_one, a, s, m, out_dir, args.timeout):
                (a, s, m) for a, s, m in work}
        for fut in as_completed(futs):
            arch, shape, mesh_tag, ok, dt, err = fut.result()
            status = "ok" if ok else "FAIL"
            print(f"[{status}] {arch}/{shape}/{mesh_tag} ({dt:.0f}s)",
                  flush=True)
            if not ok:
                fails.append((arch, shape, mesh_tag, err))
    for f in fails:
        print("FAILED:", f[:3], "\n", f[3][-500:], file=sys.stderr)
    print(f"done: {len(work) - len(fails)}/{len(work)} ok in "
          f"{time.time() - t0:.0f} s", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
