"""The threaded host row gather of csrc/pack.cc (counterpart of the JAX
package's native/__init__.py), which data/loader.py packs a batch's
feature and box rows with.

The library is built at first use by g++ (ops/kernels/build.py, which names
it by a hash of the source and the flags, as it names the CUDA libraries)
and loaded once, through ops/kernels/launch.py's `Library`. Unlike the JAX
package's loader, a failed build or load raises, and nothing switches the
native path off: numpy's fancy-index gather is its plain version, which a
caller asks for by name (`BatchLoader(..., native=False)`); only the tests
and chip_smoke.py do. `gather_rows` raises, where the JAX function returns
False, on arrays it cannot take, on a row past the table and on more rows
than `out` holds.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tf_vqa_regat_tpu_torch.ops.kernels import build, launch

SOURCE = build.CSRC_DIR / "pack.cc"
# threads of one gather (the JAX package's count)
MAX_THREADS = 8

LIB = launch.Library(SOURCE, {"regat_gather_rows": (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
     ctypes.c_int], None)})


def gather_rows(tab: np.ndarray, rows: np.ndarray, out: np.ndarray, n_threads: int = 0) -> None:
    """out[i] = tab[rows[i]] for the first len(rows) rows of `out`, zeros
    where rows[i] < 0; `tab` and `out` are C-contiguous [*, row] arrays of
    one dtype. ctypes releases the interpreter lock for the copy."""
    if not (tab.ndim == 2 and out.ndim == 2 and tab.dtype == out.dtype
            and tab.shape[1] == out.shape[1]):
        raise ValueError(
            f"gather_rows takes a [T, d] table and a [n, d] out of one dtype, got "
            f"{tab.dtype}{list(tab.shape)} and {out.dtype}{list(out.shape)}"
        )
    if not (tab.flags.c_contiguous and out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("gather_rows needs a C-contiguous table and a writeable C-contiguous out")
    rows = np.ascontiguousarray(rows, np.int64)
    if rows.ndim != 1:
        raise ValueError(f"gather_rows takes a 1-d row vector, got shape {list(rows.shape)}")
    if len(rows) > out.shape[0]:
        raise ValueError(f"gather_rows: {len(rows)} rows do not fit an out of {out.shape[0]}")
    if len(rows) and int(rows.max()) >= tab.shape[0]:
        raise IndexError(
            f"gather_rows: row {int(rows.max())} is past the table's {tab.shape[0]} rows"
        )
    if n_threads <= 0:
        n_threads = min(MAX_THREADS, os.cpu_count() or 1)
    LIB.load().regat_gather_rows(tab.ctypes.data, rows.ctypes.data, out.ctypes.data,
                            len(rows), tab.shape[1] * tab.itemsize, n_threads)


def gather_rows_plain(tab: np.ndarray, rows: np.ndarray, out: np.ndarray) -> None:
    """gather_rows's plain version: numpy's fancy index (holds the
    interpreter lock, one thread); the same bytes."""
    rows = np.asarray(rows, np.int64)
    if len(rows) and int(rows.max()) >= tab.shape[0]:
        raise IndexError(
            f"gather_rows: row {int(rows.max())} is past the table's {tab.shape[0]} rows"
        )
    g = tab[np.clip(rows, 0, None)]
    g[rows < 0] = 0
    out[: len(rows)] = g
