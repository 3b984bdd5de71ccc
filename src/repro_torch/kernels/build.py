"""Build and load the port's CUDA kernels (nvcc -> one shared library, ctypes).

Each source under ``csrc/`` has a plain C entry point that takes device
pointers and a CUDA stream, launches on that stream, allocates nothing and
returns ``cudaGetLastError()``.  The sources are compiled for ``sm_90a`` at
first use, one ``nvcc`` per source started together, and linked into
``build/kernels/libkernels-<hash>.so`` at the repository root; the hash covers
the sources and the flags, so an edited source rebuilds.  Nothing here runs
at import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SOURCES = ("rttg_latency.cu", "fedavg_reduce.cu", "server_update.cu", "rsu_reduce.cu",
           "swa_decode.cu", "ssd_scan.cu", "pairwise_cosine.cu")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# --fmad=false: every multiply and add rounds on its own, as the plain
# PyTorch versions' separate ops do (kernels that want an FMA call fmaf).
# No fast math: log10f / powf / log2f / sinf stay accurate.
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "rttg_latency_launch": (_P, _P, _I, _P, _P, _P, _P, _I, _I, _F, _F, _P, _P, _P, _P, _P),
    "fedavg_reduce_launch": (_P, _P, _I, _LL, _I, _P, _P),
    "server_update_launch": (_P, _P, _I, _P, _P, _I, _P, _LL, _P, _P, _P, _I, _I,
                             _F, _F, _F, _F, _F, _F, _I, _P, _P, _P, _P),
    "rsu_reduce_launch": (_P, _P, _P, _I, _I, _LL, _I, _P, _P, _P, _P),
    "swa_decode_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P, _P),
    "ssd_scan_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "gram_nt_launch": (_P, _P, _I, _I, _I, _P, _P),
}


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float  # wall time of the build, 0.0 when the library was cached
    ptxas_log: str  # nvcc's -Xptxas -v report (registers, spills per kernel)


_LIBRARY = None
_INFO = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False) -> BuildInfo:
    """Compile the sources in parallel and link the library; return what it cost."""
    global _INFO
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libkernels-{_digest()}.so"
    if lib.exists() and not force:
        _INFO = BuildInfo(lib, 0.0, "")
        return _INFO
    nvcc = _nvcc()
    start = time.perf_counter()
    obj_dir = Path(tempfile.mkdtemp(prefix="obj-", dir=BUILD_DIR))
    try:
        info = _compile_and_link(nvcc, obj_dir, lib)
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    _INFO = BuildInfo(lib, time.perf_counter() - start, info)
    return _INFO


def _compile_and_link(nvcc: str, obj_dir: Path, lib: Path) -> str:
    """One nvcc per source, all started together, then one link; -> ptxas log."""
    procs = []
    for name in SOURCES:
        obj = obj_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs = [], []
    for name, obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            for _, _, other in procs:
                if other.poll() is None:
                    other.kill()
                    other.wait()
            raise RuntimeError(f"nvcc failed on {name} (rc {proc.returncode}):\n{out}")
        logs.append(f"== {name}\n{out}")
        objs.append(str(obj))
    tmp = obj_dir / lib.name
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed (rc {link.returncode}):\n{link.stdout}")
    os.replace(tmp, lib)
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIBRARY
    if _LIBRARY is None:
        info = _INFO or build()
        lib = ctypes.CDLL(str(info.path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBRARY = lib
    return _LIBRARY


def check(status: int, name: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
