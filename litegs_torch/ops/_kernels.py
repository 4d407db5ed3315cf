"""Build and load the port's CUDA kernels.

Every ``litegs_torch/csrc/*.cu`` file is compiled by ``nvcc`` into its own
shared library with a plain C interface, at first use, into
``build/litegs_torch/`` at the repository root. A library's file name
carries a hash of its source and of the shared headers (``csrc/*.cuh``),
so an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing outside the repository's sources goes into a build. The sources
are compiled in parallel, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "litegs_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build litegs_torch's kernels")
    return nvcc


def _target(src: Path) -> Path:
    # the shared headers are part of every source's hash
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing; return stem -> path.

    Raises with the compiler's output if a build fails.
    """
    sources = sorted(CSRC.glob("*.cu"))
    targets = {src.stem: _target(src) for src in sources}
    todo = [s for s in sources if not targets[s.stem].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in todo:
            tmp = targets[src.stem].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, tmp, cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"$ {' '.join(cmd)}\n{out}")
            else:
                os.replace(tmp, targets[src.stem])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def library(stem: str) -> ctypes.CDLL:
    """Load the library built from ``csrc/<stem>.cu``, building first if
    needed."""
    return ctypes.CDLL(str(build_all()[stem]))
