"""Build the hand-written CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
A library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an
edited source is rebuilt and a stale library is never loaded.  Sources are
compiled in parallel (one ``nvcc`` each, all started together).  The output
goes to ``druglamp_tpu_torch/_build/``, which git ignores.

Nothing here runs at import: the CPU tests import every module and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``; its name hashes the source, every
    shared header of ``csrc/`` and the flags."""
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile each named source (default: all) whose library is missing.
    Returns the nvcc output (ptxas registers / shared memory / spills) per
    source compiled now; raises with that output if nvcc fails."""
    todo = [n for n in (list(names) if names is not None else sources())
            if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        try:
            text, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            text += f"\nnvcc timed out after {NVCC_TIMEOUT_S} s"
        logs[name] = text
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]
