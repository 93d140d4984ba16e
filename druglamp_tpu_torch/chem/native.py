"""ctypes bindings for the native featurization runtime (port of
``druglamp_tpu/chem/native.py``), over the port's own copy of the C++ source,
``druglamp_tpu_torch/csrc/native/druglamp_native.cc``.

The library is built with ``g++`` at first use into
``druglamp_tpu_torch/_build/`` (git-ignored), under a name that hashes the
source and the flags that built it, so an edited source is rebuilt and a
stale library is never loaded; concurrent first uses are serialized by an
flock, and the compiler writes to a temporary name that is renamed into
place.  When the build with ``-fopenmp`` fails (a compiler without OpenMP's
runtime), the library is built without it, under that flag set's own name
(its batch loop then runs serially); the OpenMP build is tried first in every
process.  Nothing is built at import.  ``DRUGLAMP_NO_NATIVE_BUILD=1`` builds
nothing.  Without a toolchain, ``available()`` is False and the callers use
numpy (``data/loader.py``).

    adj, deg = assemble_batch([drec.edges for drec in drugs], n_atoms, N)
    feats, edges, n = parse_featurize("CCO")
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "native" / "druglamp_native.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-fopenmp")
SERIAL_FLAGS = tuple(f for f in CXX_FLAGS if f != "-fopenmp")
BUILD_TIMEOUT_S = 120
INFO_NOT_BUILT = ("[info] native featurization runtime not built (g++ of "
                  "druglamp_tpu_torch/csrc/native at first use); using the pure-Python fallback")

_LIB: Optional[ctypes.CDLL] = None
_LIB_PATH: Optional[Path] = None
_TRIED = False


def library_path(flags: Tuple[str, ...] = CXX_FLAGS) -> Path:
    """The path under ``_build/`` of the library ``flags`` build: its name
    hashes the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdruglamp_native-{digest}.so"


def loaded_path() -> Optional[Path]:
    """The library ``load_native`` loaded, or None."""
    return _LIB_PATH if load_native() is not None else None


def _try_build(path: Path, flags: Tuple[str, ...] = CXX_FLAGS) -> bool:
    """Compile the source with ``flags`` into ``path`` (the JAX package's
    ``_try_build``: an flock serializes concurrent builds, the compiler
    writes a pid-suffixed temporary that is renamed into place).  False
    without a compiler, with ``DRUGLAMP_NO_NATIVE_BUILD=1`` or when the
    build fails."""
    cxx = os.environ.get("CXX", "g++")
    if os.environ.get("DRUGLAMP_NO_NATIVE_BUILD", "0") == "1" or shutil.which(cxx) is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        with open(BUILD_DIR / ".native.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)         # released on close
            if path.exists():                        # another process built it
                return True
            print(f"[druglamp] building the native runtime ({cxx}, first use only)...",
                  file=sys.stderr, flush=True)
            r = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                               capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
            if r.returncode == 0 and tmp.exists():
                os.rename(tmp, path)
                return True
            print(f"[druglamp] {cxx} {' '.join(flags)} exited {r.returncode}:\n"
                  f"{r.stderr[-2000:]}", file=sys.stderr, flush=True)
            return False
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, built first if needed, or None: the OpenMP build,
    else the serial one (the source guards its OpenMP loop; the same arrays
    either way)."""
    global _LIB, _LIB_PATH, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for flags in (CXX_FLAGS, SERIAL_FLAGS):
        path = library_path(flags)
        if path.exists() or _try_build(path, flags):
            break
    else:
        return None
    if flags is SERIAL_FLAGS:
        print("[druglamp] the compiler has no OpenMP runtime: the native runtime is built "
              "without -fopenmp", file=sys.stderr, flush=True)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.dl_parse_featurize.restype = ctypes.c_int
    lib.dl_parse_featurize.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.dl_assemble_batch.restype = None
    lib.dl_assemble_batch.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
    ]
    lib.dl_feature_dim.restype = ctypes.c_int
    _LIB, _LIB_PATH = lib, path
    return _LIB


def available() -> bool:
    return load_native() is not None


def _require() -> ctypes.CDLL:
    lib = load_native()
    if lib is None:
        raise RuntimeError("native library not built (no g++, or DRUGLAMP_NO_NATIVE_BUILD=1)")
    return lib


def parse_featurize(smiles: str, max_nodes: int = 512, max_edges: int = 4096
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(node_feats (n,74), edges (2,E), n_atoms) via the native parser.

    Raises ValueError on parse errors (same failure surface as the Python
    parser).  Edges are directed pairs, both directions, no self-loops.
    """
    lib = _require()
    feats = np.zeros((max_nodes, 74), np.float32)
    edges = np.zeros((2, max_edges), np.int32)
    n_atoms = ctypes.c_int32(0)
    n_edges = ctypes.c_int32(0)
    err = ctypes.create_string_buffer(256)
    rc = lib.dl_parse_featurize(
        smiles.encode(), max_nodes, max_edges,
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(n_atoms), ctypes.byref(n_edges), err, len(err))
    if rc == 1:
        raise ValueError(f"SMILES parse error: {err.value.decode()} in {smiles!r}")
    if rc == 2:
        raise ValueError(f"molecule exceeds max_nodes={max_nodes}")
    if rc == 3:
        raise ValueError(f"molecule exceeds max_edges={max_edges}")
    n, m = n_atoms.value, n_edges.value
    return feats[:n].copy(), edges[:, :m].copy(), n


def assemble_batch(edge_list, n_atoms: np.ndarray, N: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense adjacency + degrees for a batch from per-sample edge arrays.

    edge_list: sequence of (2, E_b) int32 arrays (both-direction bond pairs).
    Returns (adj (B,N,N) uint8, degrees (B,N) float32): 1 at each bond, 2 on
    the diagonal of a real atom and 1 on a padding node's, the degrees the
    row sums.
    """
    lib = _require()
    B = len(edge_list)
    na = np.ascontiguousarray(n_atoms, dtype=np.int32)
    if na.shape != (B,):
        raise ValueError(f"n_atoms of shape {na.shape} for {B} samples")
    counts = [np.shape(e)[1] for e in edge_list]
    offsets = np.zeros(B + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    total = int(offsets[-1])
    packed = np.zeros((max(total, 1), 2), np.int32)
    for b, e in enumerate(edge_list):
        e = np.asarray(e)
        if e.size and (e.min() < 0 or e.max() >= N):
            raise ValueError(f"sample {b}: an edge endpoint outside [0, {N})")
        packed[offsets[b] : offsets[b + 1], 0] = e[0]
        packed[offsets[b] : offsets[b + 1], 1] = e[1]
    adj = np.empty((B, N, N), np.uint8)
    degrees = np.empty((B, N), np.float32)
    lib.dl_assemble_batch(
        B, N,
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        na.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        degrees.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return adj, degrees
