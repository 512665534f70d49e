"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``.  The host library ``csrc/graphops.cpp`` (the graph builder's
sorts and the neighbour sampler, ``het_tpu_torch.graph.native``) is
compiled the same way by ``g++``, for any x86-64 host (no
``-march=native``).  Libraries go to ``het_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the source, the
compiler and its flags, so an edited source is rebuilt and a stale
library is never loaded; each build writes a temporary file and renames
it into place, so processes building at once never load a half-written
one.  Nothing is built at import: the first use builds what it needs, or a
caller builds several at once with :func:`build_all`, one compiler per
source, all running together.  A failed build raises with the compiler's
output.  How a kernel wrapper calls a library is ``_dispatch``'s.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List, Tuple

from ...utils import spans

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# CUDA kernels, csrc/<name>.cu
SOURCES = ("seg_reduce", "segment_mm", "compact_gat", "hgt_plain")
HOST_SOURCES = ("graphops",)  # host code, csrc/<name>.cpp
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")

NVCC_TIMEOUT_S = 600

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def cxx_path() -> str:
    return shutil.which("g++") or "g++"


def _command(name: str, out: str) -> List[str]:
    """The compiler command that builds library ``name`` into ``out``."""
    if name in HOST_SOURCES:
        return [cxx_path(), *CXX_FLAGS, "-o", out,
                os.path.join(CSRC, f"{name}.cpp")]
    return [nvcc_path(), *NVCC_FLAGS, "-o", out,
            os.path.join(CSRC, f"{name}.cu")]


def _lib_path(name: str) -> str:
    cmd = _command(name, "")  # [compiler, *flags, "-o", "", source]
    h = hashlib.sha256()
    with open(cmd[-1], "rb") as f:
        h.update(f.read())
    h.update(" ".join(cmd[:-3]).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start(name: str) -> Tuple[str, str, subprocess.Popen]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = _lib_path(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        os.remove(tmp)
        raise RuntimeError(f"cannot start the compiler for {name}: "
                           f"{_command(name, tmp)[0]}: {e}") from e
    return out, tmp, proc


def build_all(names=SOURCES) -> List[str]:
    """Compile every library of ``names`` not yet built, all compilers at
    once; returns each compiler's output (for the kernels, register and
    spill counts from ``-Xptxas -v``).  Raises if any build fails."""
    jobs, logs, failed = [], [], []
    try:
        for n in names:
            if not os.path.exists(_lib_path(n)):
                jobs.append((n, *_start(n)))
        for name, out, tmp, proc in jobs:
            text, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            logs.append(f"[{os.path.basename(_command(name, '')[0])} "
                        f"{name}]\n{text}")
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(name)
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError(
            f"build failed for {failed}:\n" + "\n".join(logs)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed: a set-up span
    ``kernels.load.<name>`` whose ``built`` counts 1 where this process
    compiled it."""
    lib = _LIBS.get(name)
    if lib is None:
        with spans.setup(f"kernels.load.{name}") as span:
            span.count("built", len(build_all((name,))))
            lib = ctypes.CDLL(_lib_path(name))
        _LIBS[name] = lib
    return lib
