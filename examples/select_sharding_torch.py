"""The paper's technique at datacenter scale, on the port: PBQP sharding
selection (``repro_torch.core.sharding_select``).

  PYTHONPATH=src python examples/select_sharding_torch.py \
      [--arch kimi-k2-1t-a32b] [--mesh pod=2,data=16,model=16]

Shows the solver choosing per-tensor-group sharding rules (TP vs EP vs
replication vs sequence-parallel stream) for each architecture x shape
on a mesh, with the collective costs priced on the H100's figures
(``H100_SPEC``, the port's default).  Pure selection: no device is
touched.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.core.sharding_select import select_rules  # noqa: E402


def _mesh(spec: str):
    out = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        out[name.strip()] = int(size)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--mesh", default="pod=2,data=16,model=16",
                    help="mesh axes and sizes (pod/data/model)")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCHS)
    mesh = _mesh(args.mesh)

    for arch in archs:
        cfg = ARCHS[arch]
        print(f"\n== {arch} on mesh {mesh} ==")
        for sname, shape in SHAPES.items():
            if sname == "long_500k" and not cfg.sub_quadratic:
                print(f"  {sname:12s} skipped (full attention)")
                continue
            rules, rep = select_rules(cfg, shape, mesh)
            asg = " ".join(f"{k}={v.split(':')[1]}"
                           for k, v in rep["assignment"].items())
            print(f"  {sname:12s} comm={rep['predicted_comm_s']*1e3:9.2f}ms"
                  f"  {asg}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
