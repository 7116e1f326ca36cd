"""Dataset IO and solver checkpointing.

Replaces the reference's MPI-IO path (``MPI_File_open`` +
``read_dense_from_file``, test_ALS.cxx:291-321) with memmapped host reads
(chunked dtype conversion, so the 2.7 GB f64 coil-100 file converts to f32
without a second full-size temp), and adds factor checkpointing the
reference lacks (SURVEY.md section 5: "add factor checkpointing anyway").

Dataset layouts. The binaries are ROW-major float64 written by the
reference's script/imageloader.py ((7200, 128, 128, 3)) and
script/matloader.py ((9, 1024, 1344, 33)). CTF reads them into tensors
declared (3, 128, 128, 7200) / (33, 1344, 1024, 9) (test_ALS.cxx:293-316)
— but CTF's global element order is COLUMN-major (first index fastest),
so the declared CTF shape is exactly the file shape reversed and the
byte stream is shared. Loading here therefore reads the file in its
row-major file shape and reverses the axes to land on the CTF-declared
mode semantics: coil-100 (channel, col, row, image), time-lapse
(band, col, row, time). Round 1 read the bytes row-major in the CTF
shape, which scrambles any real (non-random) data.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np

COIL100_SHAPE = (3, 128, 128, 7200)          # CTF-declared mode order
COIL100_FILE_SHAPE = (7200, 128, 128, 3)     # row-major on disk
TIME_LAPSE_SHAPE = (33, 1344, 1024, 9)
TIME_LAPSE_FILE_SHAPE = (9, 1024, 1344, 33)


def read_dense_binary(path: str, shape: Sequence[int], file_dtype="<f8",
                      out_dtype=np.float32, chunk_elems: int = 1 << 24
                      ) -> np.ndarray:
    """Read a row-major dense binary into ``out_dtype`` without a full-size
    intermediate copy."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    # fast path: threaded native loader (native/loader.cpp)
    if np.dtype(file_dtype) == np.dtype("<f8"):
        from pairwise_perturbation_tpu import native
        if np.dtype(out_dtype) == np.float32:
            out = native.load_f64_as_f32(path, shape)
            if out is not None:
                return out
        elif np.dtype(out_dtype) == np.float64:
            out = native.load_f64(path, shape)
            if out is not None:
                return out
    mm = np.memmap(path, dtype=file_dtype, mode="r", shape=(n,))
    out = np.empty(n, dtype=out_dtype)
    for lo in range(0, n, chunk_elems):
        hi = min(lo + chunk_elems, n)
        out[lo:hi] = mm[lo:hi]
    del mm
    return out.reshape(shape)


def write_dense_binary(path: str, V: np.ndarray, file_dtype="<f8") -> None:
    np.asarray(V, dtype=file_dtype).tofile(path)


def read_dense_sharded(path: str, layout, file_dtype="<f8",
                       out_dtype=np.float32, file_shape=None,
                       axes_perm=None):
    """Per-host sharded read of a row-major dense binary.

    The JAX replacement for the reference's MPI-IO collective read
    (``MPI_File_open`` + ``V.read_dense_from_file``, test_ALS.cxx:291-304):
    each process reads ONLY the file spans owned by its addressable
    devices (memmap slicing touches just those pages), zero-pads its
    blocks to the layout's padded shape, and the global array is assembled
    with ``jax.make_array_from_single_device_arrays`` — no host ever
    materializes the full tensor, so the weak-scaling memory story holds.

    ``layout`` is a :class:`...parallel.mesh.ShardedLayout` (from
    ``plan_layout``). ``file_shape``/``axes_perm`` view the on-disk array
    through a transpose BEFORE block extraction (composing the CTF
    axis-reversal with the tile canonicalization of utils/layout.py, so
    real datasets
    shard straight from disk in their production mode order):
    ``layout.orig_shape[i] == file_shape[axes_perm[i]]``. Returns a global
    jax.Array with the layout's NamedSharding over the PADDED shape
    (padding rows are zero, which is algebraically invisible to ALS — see
    parallel/mesh.py).
    """
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(layout.mesh, layout.v_spec())
    padded = tuple(layout.padded_shape)
    orig = tuple(layout.orig_shape)
    mm = np.memmap(path, dtype=file_dtype, mode="r",
                   shape=tuple(file_shape) if file_shape else orig)
    if axes_perm is not None:
        mm = mm.transpose(tuple(axes_perm))
        assert mm.shape == orig, (mm.shape, orig)
    idx_map = sharding.addressable_devices_indices_map(padded)
    arrays = []
    for dev, idx in idx_map.items():
        # block span in the padded index space
        spans = [(sl.start or 0, sl.stop if sl.stop is not None else p)
                 for sl, p in zip(idx, padded)]
        block_shape = tuple(hi - lo for lo, hi in spans)
        # intersection with the real (unpadded) extent
        read_slices = tuple(slice(lo, min(hi, s))
                            for (lo, hi), s in zip(spans, orig))
        block = np.zeros(block_shape, dtype=out_dtype)
        valid = tuple(slice(0, max(sl.stop - sl.start, 0))
                      for sl in read_slices)
        if all(v.stop > 0 for v in valid):
            block[valid] = mm[read_slices]
        arrays.append(jax.device_put(block, dev))
    del mm
    return jax.make_array_from_single_device_arrays(padded, sharding, arrays)


def _load_ctf_ordered(path: str, file_shape, out_dtype):
    """Read a row-major binary and reverse axes to the CTF-declared mode
    order (column-major global order == reversed row-major shape)."""
    arr = read_dense_binary(path, file_shape, out_dtype=out_dtype)
    return np.ascontiguousarray(arr.transpose(range(arr.ndim - 1, -1, -1)))


def load_coil100(path: str = "coil-100.bin", out_dtype=np.float32):
    """-> (3, 128, 128, 7200): (channel, col, row, image)."""
    return _load_ctf_ordered(path, COIL100_FILE_SHAPE, out_dtype)


def load_time_lapse(path: str = "time-lapse.bin", out_dtype=np.float32):
    """-> (33, 1344, 1024, 9): (band, col, row, time)."""
    return _load_ctf_ordered(path, TIME_LAPSE_FILE_SHAPE, out_dtype)


# ---------------------------------------------------------------------------
# Dataset builders (replacements for script/imageloader.py, script/matloader.py)
# ---------------------------------------------------------------------------


def build_coil100_binary(png_dir: str, out_path: str = "coil-100.bin"):
    """PNG directory -> float64 binary of shape (7200, 128, 128, 3)
    (imageloader.py:26-31). Requires PIL."""
    from PIL import Image  # gated: PIL is optional
    files = sorted(f for f in os.listdir(png_dir) if f.endswith(".png"))
    arr = np.zeros((len(files), 128, 128, 3), dtype=np.float64)
    for i, f in enumerate(files):
        img = Image.open(os.path.join(png_dir, f)).convert("RGB")
        arr[i] = np.asarray(img.resize((128, 128)), dtype=np.float64)
    arr.tofile(out_path)
    return out_path


def build_time_lapse_binary(mat_dir: str, out_path: str = "time-lapse.bin"):
    """9 .mat HSI files -> float64 binary (9, 1024, 1344, 33)
    (matloader.py:1-45). Requires scipy."""
    from scipy.io import loadmat  # gated: scipy is optional
    files = sorted(f for f in os.listdir(mat_dir) if f.endswith(".mat"))
    out = None
    for i, f in enumerate(files):
        m = loadmat(os.path.join(mat_dir, f))
        key = [k for k in m if not k.startswith("__")][0]
        data = np.asarray(m[key], dtype=np.float64)
        if out is None:
            out = np.zeros((len(files),) + data.shape, dtype=np.float64)
        out[i] = data
    out.tofile(out_path)
    return out_path


# ---------------------------------------------------------------------------
# Checkpointing (new capability; reference persists nothing)
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, factors: Sequence, iteration: int,
                    core=None, meta: Optional[dict] = None) -> None:
    arrays = {f"W{i}": np.asarray(W) for i, W in enumerate(factors)}
    if core is not None:
        arrays["core"] = np.asarray(core)
    arrays["_iteration"] = np.asarray(iteration)
    arrays["_meta"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_checkpoint(path: str):
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    factors: List[np.ndarray] = []
    i = 0
    while f"W{i}" in data:
        factors.append(data[f"W{i}"])
        i += 1
    core = data["core"] if "core" in data else None
    iteration = int(data["_iteration"])
    meta = json.loads(bytes(data["_meta"]).decode()) if "_meta" in data else {}
    return dict(factors=factors, core=core, iteration=iteration, meta=meta)
