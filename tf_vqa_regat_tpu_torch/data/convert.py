"""Convert the reference's HDF5 feature files to the layout the port reads
(data/features.py), once, on a machine that has h5py:

    python -m tf_vqa_regat_tpu_torch.data.convert --data_folder DIR \\
        [--splits train,val,test2015]

For every split named, each of `Bottom-up-features-adaptive/<split>.hdf5`
and `Bottom-up-features-fixed/<split>{36|_36}.hdf5` that is present becomes
a directory of the same stem beside it: one `.npy` per HDF5 dataset, under
the dataset's name and at the dtype JAX's loader gives it (f32 tables, int64
`pos_boxes`, int32 adjacency), and `meta.json` with the shapes, the dtypes
and the feature table's source fingerprint. The feature table (~58 GB f32
for the adaptive train split) is copied chunk by chunk through a memory map,
never whole in RAM. The meta file is written last and atomically, so a
reader trusts only a complete directory; a split whose meta matches its
HDF5 file is skipped. h5py is imported inside `convert_file` only: nothing
the entry point imports reaches it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from tf_vqa_regat_tpu_torch.data.features import (
    DATASET_DTYPES,
    META,
    META_VERSION,
    converted_dir,
    hdf5_path,
    read_meta,
    source_fingerprint,
)

CHUNK_ROWS = 65536  # leading-axis rows per copy of the feature table


def write_meta(directory: str, meta: dict) -> None:
    """meta.json last, atomically: readers only trust complete directories."""
    tmp = os.path.join(directory, f"{META}.{os.getpid()}.tmp")
    with open(tmp, "w") as fh:
        json.dump(meta, fh, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(directory, META))


def table_meta(source: str, arrays) -> dict:
    """The meta of a converted directory: `arrays` maps each dataset name to
    an array (or h5py dataset) of its final shape and the feature table."""
    return {
        "version": META_VERSION,
        "source": source,
        "source_fingerprint": source_fingerprint(arrays["image_features"]),
        "arrays": {k: {"shape": [int(x) for x in a.shape], "dtype": DATASET_DTYPES[k]}
                   for k, a in sorted(arrays.items())},
    }


def convert_file(h5_path: str, out_dir: str) -> bool:
    """Convert one HDF5 file into `out_dir`; False when its meta already
    matches the file (nothing written)."""
    import h5py

    with h5py.File(h5_path, "r") as hf:
        present = {k: hf[k] for k in DATASET_DTYPES if k in hf}
        meta = table_meta(os.path.basename(h5_path), present)
        if read_meta(out_dir) == meta:
            return False
        os.makedirs(out_dir, exist_ok=True)
        try:  # a stale meta must not vouch for arrays being rewritten
            os.remove(os.path.join(out_dir, META))
        except FileNotFoundError:
            pass
        for key, src in present.items():
            dtype = np.dtype(DATASET_DTYPES[key])
            out = np.lib.format.open_memmap(
                os.path.join(out_dir, key + ".npy"), mode="w+", dtype=dtype, shape=src.shape
            )
            for lo in range(0, src.shape[0], CHUNK_ROWS):
                out[lo : lo + CHUNK_ROWS] = np.asarray(src[lo : lo + CHUNK_ROWS], dtype)
            out.flush()
            del out
    write_meta(out_dir, meta)
    return True


def convert(data_folder: str, splits: List[str]) -> List[str]:
    """Convert every present HDF5 file of `splits`, adaptive and fixed-36;
    returns the directories written."""
    written = []
    for name in splits:
        for adaptive in (True, False):
            src = hdf5_path(data_folder, name, adaptive)
            if not os.path.exists(src):
                continue
            out = converted_dir(data_folder, name, adaptive)
            t0 = time.perf_counter()
            if convert_file(src, out):
                written.append(out)
                print(f"converted {src} -> {out} in {time.perf_counter() - t0:.1f} s",
                      flush=True)
            else:
                print(f"{out} is up to date", flush=True)
    return written


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data_folder", required=True)
    parser.add_argument("--splits", default="train,val,test2015")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    convert(args.data_folder, [s for s in args.splits.split(",") if s.strip()])


if __name__ == "__main__":
    main()
