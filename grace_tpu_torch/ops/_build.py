"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``*.cu`` file under ``grace_tpu_torch/csrc`` is compiled for Hopper
(``sm_90a``) into a shared library with a plain C interface; the ``*.cuh``
headers beside them are included, not compiled. The library's file name
carries a hash of its source, of every header and of the compiler flags,
so a changed source or header is rebuilt and an unchanged one is reused. Builds go to
``grace_tpu_torch/_build`` (listed in ``.gitignore``) at first use: a
fresh checkout builds its kernels on the first call that launches one.
Sources are compiled in parallel, one ``nvcc`` process each. The host
loader's ``csrc/dataloader.cpp`` is plain C++: ``host_library`` builds it
with the host compiler into the same directory.

There is no fallback: without ``nvcc``, or when the build fails, loading
raises. Only the CPU path (the kernels' plain versions) runs without it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# -fmad=false is not needed: the kernels spell every rounding step with
# __fmul_rn/__fadd_rn, which nvcc never contracts. No --use_fast_math: it
# would flush denormals and let the compiler reassociate.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: grace_tpu_torch builds its CUDA kernels from "
            "grace_tpu_torch/csrc with the CUDA toolkit's nvcc. Install the "
            "toolkit, or keep the tensors on the CPU, where the kernels' "
            "plain versions run.")
    return path


def sources() -> Dict[str, Path]:
    """Kernel sources by name (file stem)."""
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; return the library
    path of each source. The compiler's output (ptxas register and spill
    report) is kept beside each library as ``<library>.log``."""
    targets = {name: _target(src) for name, src in sources().items()}
    pending = [(name, sources()[name], t) for name, t in targets.items()
               if not t.exists()]
    if not pending:
        return targets
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, src, target in pending:
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        target.with_name(target.name + ".log").write_text(out)
        os.replace(tmp, target)           # atomic: no half-written library
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return targets


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build_all()[name]))


# The host loader (csrc/dataloader.cpp): plain C++ for the host compiler,
# never nvcc, and no header of the CUDA toolkit or PyTorch.
HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")


def find_host_cxx() -> str:
    path = shutil.which("c++") or shutil.which("g++")
    if path is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) found to build "
                           "grace_tpu_torch/csrc/dataloader.cpp")
    return path


@functools.cache
def host_library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<name>.cpp`` with the
    host C++ compiler, into ``_build/lib<name>-<hash>.so`` (the hash of the
    source and the flags); built at the first call, reused after."""
    src = CSRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(HOST_CXX_FLAGS).encode())
    target = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not target.exists():
        cxx = find_host_cxx()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *HOST_CXX_FLAGS, str(src), "-o",
                               str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, target)           # atomic: no half-written library
    return ctypes.CDLL(str(target))


def build_log(name: str) -> str:
    """The compiler's output for ``csrc/<name>.cu`` ('' before a build)."""
    log = _target(sources()[name])
    log = log.with_name(log.name + ".log")
    return log.read_text() if log.exists() else ""
