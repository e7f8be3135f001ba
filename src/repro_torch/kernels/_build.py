"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Every ``csrc/*.cu`` is compiled on first use into its own shared library
with a plain C interface, one ``nvcc`` per source, all started together.
Libraries land in ``build/repro_torch_kernels/<key>/`` at the repository
root, where ``<key>`` hashes the sources and the flags, so an edited
source rebuilds and an unchanged one is loaded as it is.  Nothing here
runs at import time: the CPU tests import every module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

__all__ = ["NVCC_FLAGS", "build_dir", "build_all", "load", "build_log"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: sm_90a so Hopper-only instructions stay available; no fast math (it
#: would flush denormals); --fmad=false so no product feeding a sum is
#: contracted into an FMA — the kernels must match their plain versions
#: bit for bit.  -Xptxas -v records registers and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels are built on first use")
    return path


def build_dir() -> Path:
    """The content-keyed directory the current sources build into."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Build every missing library in parallel; ``{name: path}``."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: (src, out / f"lib{src.stem}.so")
            for src in sorted(_CSRC.glob("*.cu"))}
    todo = {n: v for n, v in libs.items() if not v[1].exists()}
    nvcc = _nvcc() if todo else None
    procs = []
    for name, (src, lib) in todo.items():
        tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(src)]
        log = open(out / f"{name}.log", "w")
        procs.append((name, tmp, lib, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, lib, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}; see the logs in {out}:\n"
            + "\n".join(build_log(n) for n in failed))
    return {name: lib for name, (_, lib) in libs.items()}


def build_log(name: str) -> str:
    """The compiler's output (ptxas registers / spills) for one source."""
    path = build_dir() / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build_all()[name]))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib
