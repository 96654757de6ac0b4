"""Packed-feature cache protocol (--packed_cache), the port's copy of
tf_vqa_regat_tpu/data/cache.py.

The converted feature table (and int8's per-row scales) persists as `.npy`;
a meta sidecar holding the cache signature is written last and atomically
(tmp + os.replace), so a reader trusts only a complete cache and concurrent
first runs race benignly. bf16 is stored as its uint16 bits, as JAX stores
it. Reads are memory-mapped. The file names, the key and the signature are
JAX's (device_store.py:111-150), so one cache directory serves both
packages: a cache that either wrote is a hit for the other.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional, Tuple

import numpy as np

VERSION = 2


def cache_paths(cache_dir: str, fingerprint: str, adaptive: bool, feature_dtype: str):
    """(meta, features, scale) paths of a table, keyed by its content
    (`feat-{sha1[:16]}-{layout}-{dtype}`), not by split name: VQA-CP's two
    splits share one merged table and one cache entry."""
    key = f"feat-{fingerprint[:16]}-{'adaptive' if adaptive else 'fixed'}-{feature_dtype}"
    return tuple(os.path.join(cache_dir, key + s)
                 for s in (".meta.json", ".features.npy", ".scale.npy"))


def signature(src_shape, fingerprint: str, feature_dtype: str) -> dict:
    return {
        "src_shape": [int(x) for x in src_shape],
        "src_sha1": fingerprint,
        "feature_dtype": feature_dtype,
        "version": VERSION,
    }


def load_packed_cache(
    meta_p: str, feat_p: str, scale_p: str, sig: dict, feature_dtype: str,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(features, scales) memory-mapped from a complete cache whose meta
    equals `sig`, else (None, None). bf16 features come back as their uint16
    bits; int8 brings its f32 scales, the other dtypes None."""
    try:
        with open(meta_p) as fh:
            if json.load(fh) != sig:
                return None, None
        feat = np.load(feat_p, mmap_mode="r")
        scale = np.load(scale_p, mmap_mode="r") if feature_dtype == "int8" else None
        return feat, scale
    except (OSError, ValueError):
        return None, None


def save_packed_cache(
    meta_p: str, feat_p: str, scale_p: str, sig: dict,
    chunks: Iterable[Tuple[int, int, np.ndarray, Optional[np.ndarray]]],
    shape: Tuple[int, ...], feat_dtype: np.dtype, with_scale: bool,
) -> None:
    """Write the table of `chunks` (a range a:b of its first axis, those rows
    at the stored dtype, their scales or None) chunk by chunk through memory
    maps, each file under a temporary name then renamed, and the meta last.
    The table is [T, v], or the sharded store's [dp, max_rows, v] with
    [dp, max_rows] scales."""
    os.makedirs(os.path.dirname(meta_p) or ".", exist_ok=True)
    tmp = {p: f"{p}.{os.getpid()}.tmp" for p in (feat_p, scale_p)}
    feat = np.lib.format.open_memmap(tmp[feat_p], mode="w+", dtype=feat_dtype, shape=shape)
    scale = (np.lib.format.open_memmap(tmp[scale_p], mode="w+", dtype=np.float32,
                                       shape=shape[:-1]) if with_scale else None)
    for a, b, f, s in chunks:
        feat[a:b] = f
        if scale is not None:
            scale[a:b] = s
    feat.flush()
    os.replace(tmp[feat_p], feat_p)
    if scale is not None:
        scale.flush()
        os.replace(tmp[scale_p], scale_p)
    del feat, scale
    tmp_meta = f"{meta_p}.{os.getpid()}.tmp"
    with open(tmp_meta, "w") as fh:
        json.dump(sig, fh)
    os.replace(tmp_meta, meta_p)  # meta last: readers only trust complete caches
