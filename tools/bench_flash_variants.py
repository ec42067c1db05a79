#!/usr/bin/env python3
"""Times variants of the flash-attention kernel (K6) beside the kernel as
it is, on the card, to test design choices that its source does not
expose as parameters.

    python3 tools/bench_flash_variants.py [VARIANT ...]

Each variant is ``src/repro_torch/csrc/flash_attention.cu`` with one
edit, built with the port's ``nvcc`` flags into
``build/flash_variants/`` (one ``nvcc`` per variant, in parallel) and
loaded in place of the kernel's library:

- ``base``: the source as it is;
- ``tile8x8``: 8 query rows per thread up to DP = 64 (8 x 8 logits and
  8 x DP/8 outputs: more FMAs per shared-memory read, two warps per
  64-row block);
- ``q128``: DP = 64's 64-row instantiation built with 128 rows (eight
  warps per block);
- ``noq``: the Q fragments not read from shared memory (wrong results:
  it measures what those reads cost).

Each is timed at the calibration sweep's two shapes (f32, non-causal)
over a few query tiles and KV splits, as ``chip_smoke.cuda_ms`` times
(device ms per call); each row also gives the error against the plain
version and the DP = 64 wide f32 kernel's registers and spill bytes.  One
JSON object per line on stdout; needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "flash_variants"

#: variant -> (text of the source, its replacement)
EDITS = {
    "base": [],
    "tile8x8": [("TM = DP <= 128 ? 4 : 2;",
                 "TM = DP <= 64 ? 8 : DP <= 128 ? 4 : 2;")],
    "q128": [("wide ? launch<Cfg<64, 64>, T, false>",
              "wide ? launch<Cfg<64, 128>, T, false>")],
    "noq": [("""      qa[i] = *reinterpret_cast<const float4*>(
          Qs + (row0 + i * C::WY) * C::PQ + d);""",
             "      qa[i] = make_float4(d, d + 1, i, row0);")],
}
#: (B, H, L, D) -> the (BQ, S) plans timed
PLANS = {(1, 4, 1024, 64): [(64, 1), (64, 2), (64, 3), (64, 4), (32, 2)],
         (1, 4, 256, 64): [(64, 2), (64, 4), (32, 4)]}


def build(names):
    """One nvcc per variant, all started together; returns name -> (.so,
    ptxas report)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.common import CSRC_DIR, NVCC_FLAGS, _nvcc
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = SOURCE.read_text()
        for old, new in EDITS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: the source has no {old!r}")
            text = text.replace(old, new)
        src = OUT / f"flash_{name}.cu"
        src.write_text(text)
        so = OUT / f"flash_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{out}")
        built[name] = (so, out)
    return built


def main(argv=None) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_flash_variants: no CUDA device", file=sys.stderr)
        return 2
    names = (argv if argv is not None else sys.argv[1:]) or list(EDITS)
    built = build(names)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, gpu_line
    from repro_torch.kernels.common import ptxas_usage
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.plan import make_plan
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    card = gpu_line()
    rng = np.random.default_rng(0)
    argtypes = fk.LIB.entries["repro_flash_attention"]
    for name in names:
        so, report = built[name]
        wide = "128" if name == "q128" else "64"
        usage = next(u for k, u in ptxas_usage(report).items()
                     if f"CfgILi64ELi{wide}EEEfLb0" in k)
        lib = ctypes.CDLL(str(so))
        lib.repro_flash_attention.argtypes = list(argtypes)
        lib.repro_flash_attention.restype = ctypes.c_int
        fk.LIB._lib = lib
        for (b, h, l, d), plans in PLANS.items():
            q, k, v = (torch.from_numpy(rng.normal(size=(b, h, l, d)).astype(
                np.float32)).cuda() for _ in range(3))
            want = flash_attention_ref(q, k, v, scale=d ** -0.5)
            for bq, s in plans:
                plan = make_plan(b, h, l, d, 64, bq, s)

                def run():
                    return fk.flash_attention_cuda(q, k, v, scale=d ** -0.5,
                                                   plan=plan)
                err = float((run() - want).abs().max() / want.abs().max())
                # q128 builds the 64-row plan's blocks with 128 rows
                rows = 128 if name == "q128" and bq == 64 else bq
                print(json.dumps(dict(
                    card=card, variant=name, shape=str((b, h, l, d)),
                    rows=rows, splits=s, ms=cuda_ms(torch, run), rel_err=err,
                    registers=usage["registers"], spill=usage["spill"])),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
