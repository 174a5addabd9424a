"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process into a
shared library with a plain C interface (all processes started together),
into ``build/kernels/`` of the checkout, and loaded with ctypes. Nothing is
compiled when the package is imported: the first call that needs a kernel
builds it. A library whose name carries the hash of its sources and flags is
reused, so a rebuild happens only after an edit; its ptxas lines are kept
beside it for the build report.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("texel_rows", "fragment", "composite", "composite_bwd",
           "single_channel")

# -fmad=false: no FMA contraction, so every product and sum rounds as in the
# plain PyTorch versions (integer decisions of K1/K2 must agree exactly; the
# coverage test of K3-K6 is a threshold too). No fast math: IEEE division, sqrtf and
# expf are kept.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
report: dict[str, dict] = {}   # per source: seconds, ptxas lines, cached


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and pathlib.Path(cand).exists():
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use"
    )


def _tag(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib_m2s_{name}_{_tag(name)}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that have no current library, one nvcc
    process each, all at once. Returns the build report (seconds and the
    -Xptxas -v register / shared-memory / spill lines per source). Raises
    if any compile fails."""
    todo = [n for n in names if not _lib_path(n).exists()]
    for n in names:
        if n not in todo:
            log = _lib_path(n).with_suffix(".ptxas")
            lines = log.read_text().splitlines() if log.exists() else []
            report.setdefault(n, {"seconds": 0.0, "ptxas": lines,
                                  "cached": True})
    if not todo:
        return report
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _lib_path(n).with_suffix(".tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        lines = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln
                 or "Function properties" in ln]
        report[n] = {"seconds": time.perf_counter() - t0, "ptxas": lines,
                     "cached": False}
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{out}")
        else:
            _lib_path(n).with_suffix(".ptxas").write_text("\n".join(lines))
            tmp.replace(_lib_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
