"""Shared machinery of the port's Hopper kernels: build, load, count, dispatch.

Counterpart of the reference's ``kernels/common.py``.  Its
``use_interpret`` (run Pallas bodies in Python off the TPU) becomes one
device check: a wrapper takes its plain PyTorch version for a CPU tensor
(:func:`on_cpu`) and hands anything else to its binding, whose
:func:`require_cuda` launches the kernel only for operands on one sm_90
card and raises otherwise.  Nothing falls back: a tensor on another
device or card, or a kernel that does not build or launch, raises.

Each CUDA source under ``repro_torch/csrc/`` is compiled on first use by
``nvcc`` into its own shared library with a plain C interface (no
PyTorch headers, so a build takes seconds), cached under
``build/repro_torch/`` by a hash of the sources and flags, and loaded
with ``ctypes``.  Every C entry returns ``cudaGetLastError()``.  The
compiler's report (``-Xptxas -v``: registers, shared memory and spills
per kernel) is kept beside each library (:meth:`KernelLib.ptxas_report`).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Sequence

import torch

__all__ = ["cdiv", "on_cpu", "require_cuda", "true_f32", "resolve_device",
           "KernelLib", "build_all", "count_launch", "launch_counts",
           "reset_launch_counts", "ptxas_usage", "CSRC_DIR", "BUILD_DIR",
           "NVCC_FLAGS"]

CSRC_DIR = pathlib.Path(__file__).resolve().parents[1] / "csrc"
#: ``<checkout>/build/repro_torch`` — git-ignored, made at first build
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the compute capability the ``sm_90a`` binaries run on
_CAPABILITY = (9, 0)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_device(device=None) -> torch.device:
    """An entry point's device: ``None`` means the card.

    Raises when CUDA is asked for (explicitly or by default) and no GPU
    is present — entry points never carry on on the CPU unasked.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def on_cpu(x: torch.Tensor) -> bool:
    """A wrapper's dispatch: True runs the plain version (``x`` lies on
    the CPU); False launches the kernel, whose binding checks every
    operand with :func:`require_cuda`."""
    return x.device.type == "cpu"


def require_cuda(*tensors: Optional[torch.Tensor]) -> None:
    """The bindings' one device guard: every operand on one CUDA device,
    an sm_90 card.  Raises otherwise (CPU operands belong to the
    wrappers' plain versions)."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors on one "
                         f"device; got {sorted(map(str, devs))}")
    cap = torch.cuda.get_device_capability(devs.pop())
    if cap != _CAPABILITY:
        raise RuntimeError(f"the kernels are built for sm_90a; this card "
                           f"is sm_{cap[0]}{cap[1]}")


@contextlib.contextmanager
def true_f32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after.

    The reference accumulates convolutions and GEMMs in true f32; TF32
    keeps about 3 decimal digits, which would put the library primitives
    outside the parity tolerances.  Scoped, so that other PyTorch code in
    the process keeps its own setting.
    """
    mm, dnn = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn


# ----------------------------------------------------------------------
# launch counters: each wrapper adds one where it launches its kernel
# ----------------------------------------------------------------------
_COUNT_LOCK = threading.Lock()
_LAUNCHES: Dict[str, int] = {}


def count_launch(name: str) -> None:
    with _COUNT_LOCK:
        _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        _LAUNCHES.clear()


# ----------------------------------------------------------------------
# build + load
# ----------------------------------------------------------------------
def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels cannot be built")
    return found


class KernelLib:
    """One CUDA source, its shared library and its C entry points.

    ``entries`` maps each exported C function to its ``ctypes`` argument
    types; every entry returns a ``cudaError_t`` as ``int``.
    """

    def __init__(self, source: str,
                 entries: Dict[str, Sequence[type]]) -> None:
        self.source = CSRC_DIR / source
        self.entries = dict(entries)
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    @property
    def so_path(self) -> pathlib.Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        # the source and every header it may include
        for p in [self.source] + sorted(CSRC_DIR.glob("*.cuh")):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this source unless its library is built.

        Writes to a per-process temporary name, renamed into place by
        :meth:`finish_build`, so concurrent builders never load a
        half-written library.
        """
        if self.so_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.so_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        tmp = pathlib.Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(exit {proc.returncode}):\n{out}")
        self.report_path.write_text(out)
        os.replace(tmp, self.so_path)

    @property
    def report_path(self) -> pathlib.Path:
        return self.so_path.with_suffix(".ptxas.txt")

    def ptxas_report(self) -> str:
        """What ``nvcc -Xptxas -v`` printed when the library was built."""
        return self.report_path.read_text()

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.so_path))
                for name, argtypes in self.entries.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def call(self, entry: str, *args) -> None:
        """Launch through one C entry; raise on a non-zero CUDA error."""
        rc = getattr(self.lib(), entry)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.source.name}:{entry} failed with "
                               f"cudaError {rc}")


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def ptxas_usage(report: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) of a ``-Xptxas -v`` report: registers,
    static shared memory, stack frame and spill bytes (stores + loads)."""
    usage: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in report.splitlines():
        if (m := _PTXAS_ENTRY.search(line)):
            cur = usage.setdefault(m.group(1), {"registers": 0, "smem": 0,
                                                "stack": 0, "spill": 0})
        elif cur is not None and (m := _PTXAS_SPILL.search(line)):
            cur["stack"] = int(m.group(1))
            cur["spill"] = int(m.group(2)) + int(m.group(3))
        elif cur is not None and (m := _PTXAS_USED.search(line)):
            cur["registers"] = int(m.group(1))
            cur["smem"] = int(m.group(2) or 0)
    return usage


def build_all(libs: Iterable[KernelLib]) -> List[pathlib.Path]:
    """Build every library at once: one ``nvcc`` per source, all started
    together, then wait for each.  Returns the library paths."""
    libs = list(libs)
    procs = [lib.start_build() for lib in libs]
    errors = []
    for lib, proc in zip(libs, procs):
        try:  # wait for every nvcc before reporting, leaving none running
            lib.finish_build(proc)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return [lib.so_path for lib in libs]


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """The current PyTorch stream of ``device`` as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
