"""Build the port's native code at first use and load it with ctypes.

CUDA kernels: every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of its source, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Outputs go to
``memgraph_tpu_torch/_build/`` (listed in .gitignore).  A failed build
raises: nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_kernels: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def lib_path(src: str, suffix: str = ".so") -> str:
    """Build output for ``src``: named by the source's content hash."""
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{name}-{digest}{suffix}")


def compile_all(jobs: list[tuple[list[str], str]]) -> None:
    """Run compiler command lines in parallel, each writing to a temporary
    name that is renamed onto its output once it succeeded (an
    interrupted build never leaves a half-written library behind)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for cmd, out in jobs:
        tmp = f"{out}.tmp{os.getpid()}"
        procs.append((subprocess.Popen(
            cmd + ["-o", tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT), tmp, out, cmd))
    errors = []
    for proc, tmp, out, cmd in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            errors.append(f"{' '.join(cmd)}\n{log.decode(errors='replace')}")
    if errors:
        raise RuntimeError("build failed:\n" + "\n".join(errors))


def load_kernels() -> dict:
    """{source name: ctypes.CDLL} for every ``csrc/*.cu``, compiling the
    ones whose library is missing (all in parallel)."""
    with _lock:
        if _kernels:
            return _kernels
        srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
        outs = {src: lib_path(src) for src in srcs}
        todo = [src for src in srcs if not os.path.exists(outs[src])]
        if todo:
            nvcc = _nvcc()
            compile_all([([nvcc] + NVCC_FLAGS + [src], outs[src])
                         for src in todo])
        for src in srcs:
            name = os.path.splitext(os.path.basename(src))[0]
            _kernels[name] = ctypes.CDLL(outs[src])
        return _kernels
