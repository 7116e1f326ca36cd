"""ctypes bindings to the native C++ runtime components (native/).

Components (each with a pure-Python fallback so the package works without
the .so):

- :func:`plan_chain_priority` — contraction-order planner (native/planner.cpp)
- :func:`plan_tree_split`     — dimension-tree split planner
- :func:`pp_cache_flops`      — PP cache-build FLOP estimate
- :func:`load_f64_as_f32` / :func:`load_f64` — threaded binary loader
  (native/loader.cpp), used by utils.io when available.

The library is built from ``native/*.cpp`` with g++ at first use (no
external deps) into ``native/libppnative.so``, which git ignores. It is
rebuilt whenever a source is newer than it, and each build writes a
temporary file that is renamed into place, so concurrent processes (e.g.
pytest-xdist workers) never load a half-written or stale library.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libppnative.so")

_lib = None
_tried = False


def _sources() -> List[str]:
    return sorted(glob.glob(os.path.join(_NATIVE_DIR, "*.cpp")))


def _stale() -> bool:
    """True when the library is missing or older than any source."""
    if not os.path.exists(_SO_PATH):
        return True
    built = os.path.getmtime(_SO_PATH)
    return any(os.path.getmtime(src) > built for src in _sources())


def _build() -> bool:
    """Compile the sources into a temporary file, then rename it into
    place (atomic on POSIX)."""
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-fPIC",
           "-Wall", "-shared", "-pthread", "-o", tmp, *_sources()]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO_PATH)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if _stale() and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
        lib.plan_chain_priority.restype = ctypes.c_double
        lib.plan_chain_priority.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int)]
        lib.plan_tree_split.restype = ctypes.c_int
        lib.plan_tree_split.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double)]
        lib.plan_pp_cache_flops.restype = ctypes.c_double
        lib.plan_pp_cache_flops.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int64]
        lib.plan_tree_split_traffic.restype = ctypes.c_int
        lib.plan_tree_split_traffic.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double)]
        lib.load_f64_as_f32.restype = ctypes.c_int
        lib.load_f64_as_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.load_f64.restype = ctypes.c_int
        lib.load_f64.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def plan_chain_priority(sizes: Sequence[int], rank: int
                        ) -> Tuple[List[int], float]:
    """(priority, peak_intermediate_elems). Python fallback = descending size."""
    lib = _load()
    order = len(sizes)
    if lib is None:
        pr = sorted(range(order), key=lambda m: (-sizes[m], m))
        total = float(np.prod([float(s) for s in sizes]))
        cur, peak = total, total
        for m in pr:
            cur /= sizes[m]
            peak = max(peak, cur * rank)
        return pr, peak
    arr = (ctypes.c_int64 * order)(*[int(s) for s in sizes])
    out = (ctypes.c_int * order)()
    peak = lib.plan_chain_priority(arr, order, int(rank), out)
    return list(out), float(peak)


def plan_tree_split(sizes: Sequence[int], rank: int) -> Tuple[int, float]:
    """Best root split s for the binary DT; fallback = middle split
    (the reference's fixed (start+end)//2, common.cxx:252)."""
    lib = _load()
    order = len(sizes)
    if lib is None:
        return (order - 1) // 2, float("nan")
    arr = (ctypes.c_int64 * order)(*[int(s) for s in sizes])
    fl = ctypes.c_double()
    s = lib.plan_tree_split(arr, order, int(rank), ctypes.byref(fl))
    return int(s), float(fl.value)


def plan_tree_split_traffic(sizes: Sequence[int], rank: int
                            ) -> Tuple[int, float, float]:
    """Best root split by memory TRAFFIC (elements moved per sweep) — the
    objective that predicts bandwidth-bound DT sweep time (a FLOP model
    over-promises on skewed shapes such as coil-100). Returns
    (split, best_traffic, midpoint_traffic) so callers can report the
    modeled saving honestly. Fallback = reference midpoint."""
    lib = _load()
    order = len(sizes)
    if lib is None:
        return (order - 1) // 2, float("nan"), float("nan")
    arr = (ctypes.c_int64 * order)(*[int(s) for s in sizes])
    t = ctypes.c_double()
    tm = ctypes.c_double()
    s = lib.plan_tree_split_traffic(arr, order, int(rank),
                                    ctypes.byref(t), ctypes.byref(tm))
    return int(s), float(t.value), float(tm.value)


def pp_cache_flops(sizes: Sequence[int], rank: int) -> float:
    lib = _load()
    if lib is None:
        return float("nan")
    order = len(sizes)
    arr = (ctypes.c_int64 * order)(*[int(s) for s in sizes])
    return float(lib.plan_pp_cache_flops(arr, order, int(rank)))


def load_f64_as_f32(path: str, shape: Sequence[int],
                    n_threads: int = 0) -> Optional[np.ndarray]:
    """Threaded f64-file -> f32 array load; None if native lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = int(np.prod([int(s) for s in shape]))
    out = np.empty(n, dtype=np.float32)
    rc = lib.load_f64_as_f32(
        path.encode(), 0, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    if rc != 0:
        return None
    return out.reshape(tuple(int(s) for s in shape))


def load_f64(path: str, shape: Sequence[int],
             n_threads: int = 0) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    n = int(np.prod([int(s) for s in shape]))
    out = np.empty(n, dtype=np.float64)
    rc = lib.load_f64(
        path.encode(), 0, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_threads)
    if rc != 0:
        return None
    return out.reshape(tuple(int(s) for s in shape))
