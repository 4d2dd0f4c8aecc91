"""HNSW graph index — Python binding over the native C++ core.

Counterpart of rag_icd10_tpu/index/hnsw_index.py: the same ctypes
binding over the same source, ``native/hnsw/hnsw.cpp``. The graph runs on
the host by design, as in the JAX package. Search semantics match the
store's: raw inner product from the graph, then the ICD level weights
x{1.2, 1.0, 0.8} are applied to the returned top-k and re-sorted —
exactly what the reference does with the candidates Milvus returns
(services/milvus_service.py:292-316).

The shared library is built from ``native/hnsw/hnsw.cpp`` with ``g++``
and the flags of ``native/hnsw/Makefile`` into ``build/torch_kernels/``
(git ignores it), named by a hash of the source and the flags, at first
use; the source directory is only read. The build runs under a lock (a
thread lock and a lock file, so concurrent processes build once) and
renames its output into place atomically. A failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "hnsw" / "hnsw.cpp"
BUILD_DIR = _ROOT / "build" / "torch_kernels"
#: native/hnsw/Makefile's CXXFLAGS, plus -shared for its link step
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhnsw-{digest.hexdigest()[:16]}.so"


def _build_library(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "hnsw.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)  # one build across processes
        if lib.exists():
            return
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        out = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
            capture_output=True, text=True,
        )
        if out.returncode != 0:
            raise RuntimeError(
                f"HNSW library build failed (g++ exited {out.returncode}):\n"
                f"{out.stdout}{out.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a reader never sees half a file


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build_library(path)
        lib = ctypes.CDLL(str(path))
        lib.hnsw_create.restype = ctypes.c_void_p
        lib.hnsw_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ]
        lib.hnsw_create2.restype = ctypes.c_void_p
        lib.hnsw_create2.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int,
        ]
        lib.hnsw_is_bf16.restype = ctypes.c_int
        lib.hnsw_is_bf16.argtypes = [ctypes.c_void_p]
        lib.hnsw_compact.argtypes = [ctypes.c_void_p]
        lib.hnsw_free.argtypes = [ctypes.c_void_p]
        lib.hnsw_add_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ]
        lib.hnsw_add_batch_parallel.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.hnsw_search_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.hnsw_size.restype = ctypes.c_int
        lib.hnsw_size.argtypes = [ctypes.c_void_p]
        lib.hnsw_dim.restype = ctypes.c_int
        lib.hnsw_dim.argtypes = [ctypes.c_void_p]
        lib.hnsw_memory_bytes.restype = ctypes.c_uint64
        lib.hnsw_memory_bytes.argtypes = [ctypes.c_void_p]
        lib.hnsw_save.restype = ctypes.c_int
        lib.hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.hnsw_load.restype = ctypes.c_void_p
        lib.hnsw_load.argtypes = [ctypes.c_char_p]
        _lib = lib
        return lib


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class HNSWIndex:
    """Inner-product HNSW; vectors stored fp32 or bf16 in-graph.

    vec_dtype="bfloat16" halves graph memory (the equal-memory claim of
    BASELINE config #2); returned IPs then carry bf16 rounding — the
    store's hnsw path re-ranks candidates against its fp32 matrix."""

    def __init__(
        self,
        dim: int,
        M: int = 16,
        ef_construction: int = 200,
        seed: int = 42,
        vec_dtype: str = "float32",
        _handle=None,
    ):
        self.lib = load_library()
        self.dim = dim
        self.M = M
        self.ef_construction = ef_construction
        if _handle is not None:
            self._h = _handle
        else:
            self._h = self.lib.hnsw_create2(
                dim, M, ef_construction, seed,
                1 if vec_dtype == "bfloat16" else 0,
            )
        if not self._h:
            raise RuntimeError("hnsw_create failed")
        self.vec_dtype = (
            "bfloat16" if self.lib.hnsw_is_bf16(self._h) else "float32"
        )

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self.lib.hnsw_free(self._h)
                self._h = None
        except Exception:
            pass

    def add(self, vectors: np.ndarray, threads: int = 0) -> None:
        """Insert a batch. threads=0 parallelizes across all hardware
        threads for large batches (lock-based construction with a serial
        seed phase); threads=1 forces the deterministic serial build."""
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        assert v.ndim == 2 and v.shape[1] == self.dim, v.shape
        if threads == 1 or v.shape[0] < 2048:
            self.lib.hnsw_add_batch(self._h, v.shape[0], _fptr(v))
        else:
            self.lib.hnsw_add_batch_parallel(
                self._h, v.shape[0], _fptr(v), threads
            )

    def search(
        self, queries: np.ndarray, k: int, ef_search: int = 64
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, D) -> (ip scores (B,k), indices (B,k)); -1 index = no hit."""
        q = np.ascontiguousarray(np.atleast_2d(queries), dtype=np.float32)
        nq = q.shape[0]
        out_idx = np.empty((nq, k), dtype=np.int32)
        out_ip = np.empty((nq, k), dtype=np.float32)
        self.lib.hnsw_search_batch(
            self._h, nq, _fptr(q), k, ef_search, _iptr(out_idx), _fptr(out_ip)
        )
        return out_ip, out_idx

    def __len__(self) -> int:
        return self.lib.hnsw_size(self._h)

    def compact(self) -> None:
        """Release build-time allocation slack (growth-doubling + degree
        reserves hold up to ~2x the live bytes). Serial only."""
        self.lib.hnsw_compact(self._h)

    def memory_bytes(self) -> int:
        return int(self.lib.hnsw_memory_bytes(self._h))

    def save(self, path: str) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        if not self.lib.hnsw_save(self._h, str(path).encode()):
            raise IOError(f"hnsw_save failed: {path}")

    @classmethod
    def load(cls, path: str) -> "HNSWIndex":
        lib = load_library()
        handle = lib.hnsw_load(str(path).encode())
        if not handle:
            raise IOError(f"hnsw_load failed: {path}")
        dim = lib.hnsw_dim(handle)
        return cls(dim=dim, _handle=handle)
