"""Region-feature store and the VQA dataset facade (counterpart of
tf_vqa_regat_tpu/data/features.py), read from the converted layout.

The reference ships its bottom-up-attention features as HDF5. The port reads
a converted copy of each file instead, so that it needs no h5py:
data/convert.py, run once where h5py is, writes beside every
`Bottom-up-features-{adaptive,fixed}/<split>[36|_36].hdf5` a directory of
the same stem holding one `.npy` per HDF5 dataset, under the dataset's name,
at the dtype JAX's loader gives it, and a `meta.json` written last:

  adaptive: image_features [total_boxes, v] f32, spatial_features
            [total_boxes, 6] f32, image_bb [total_boxes, 4] f32, pos_boxes
            [num_images, 2] int64
  fixed-36: image_features [num_images, 36, v] f32, spatial_features
            [num_images, 36, 6], image_bb [num_images, 36, 4]
  either:   semantic_adj_matrix and image_adj_matrix [num_images, 100, 100]
            int32 where the file has them

With `mmap` (--mmap_features) the feature table is memory-mapped and the
device store converts and uploads it chunk by chunk (data/store.py); the
other tables are small and always read whole.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from tf_vqa_regat_tpu_torch.data.dictionary import Dictionary
from tf_vqa_regat_tpu_torch.data.entries import EntryTable, load_entries

META = "meta.json"
META_VERSION = 1
# HDF5 dataset name -> the dtype JAX's loader reads it at (features.py:90-102)
DATASET_DTYPES = {
    "image_features": "float32",
    "spatial_features": "float32",
    "image_bb": "float32",
    "pos_boxes": "int64",
    "semantic_adj_matrix": "int32",
    "image_adj_matrix": "int32",
}


def split_stem(name: str, adaptive: bool) -> str:
    """The file stem of a split (reference dataset.py:183-199): fixed-36
    test splits take '_36', train and val '36', adaptive nothing."""
    return name + ("" if adaptive else ("_36" if "test" in name else "36"))


def feature_root(dataroot: str, adaptive: bool) -> str:
    return os.path.join(
        dataroot, "Bottom-up-features-adaptive" if adaptive else "Bottom-up-features-fixed"
    )


def hdf5_path(dataroot: str, name: str, adaptive: bool) -> str:
    return os.path.join(feature_root(dataroot, adaptive), split_stem(name, adaptive) + ".hdf5")


def converted_dir(dataroot: str, name: str, adaptive: bool) -> str:
    return os.path.join(feature_root(dataroot, adaptive), split_stem(name, adaptive))


def source_fingerprint(src) -> str:
    """sha1 over the table's shape and ~64 strided rows read as f32 (JAX
    device_store.py:97-110): the content identity of the converted meta
    and of the packed cache's key."""
    import hashlib

    h = hashlib.sha1()
    h.update(repr(tuple(src.shape)).encode())
    n = src.shape[0]
    step = max(n // 64, 1)
    for lo in range(0, n, step):
        h.update(np.asarray(src[lo : lo + 1], np.float32).tobytes())
    return h.hexdigest()


def convert_command(dataroot: str, name: str) -> str:
    return (f"python -m tf_vqa_regat_tpu_torch.data.convert --data_folder {dataroot} "
            f"--splits {name}")


@dataclass
class FeatureStore:
    adaptive: bool
    features: np.ndarray  # adaptive: [total_boxes, v]; fixed: [num_img, 36, v]
    normalized_bb: np.ndarray  # matching layout, 6-d
    bb: np.ndarray  # matching layout, 4-d
    pos_boxes: Optional[np.ndarray] = None  # adaptive only, [num_img, 2]
    semantic_adj: Optional[np.ndarray] = None  # [num_img, 100, 100]
    spatial_adj: Optional[np.ndarray] = None  # [num_img, 100, 100]

    @property
    def features_lazy(self) -> bool:
        """The feature table is memory-mapped (--mmap_features)."""
        return isinstance(self.features, np.memmap)

    @property
    def v_dim(self) -> int:
        return self.features.shape[-1]

    @property
    def num_images(self) -> int:
        return self.pos_boxes.shape[0] if self.adaptive else self.features.shape[0]


def read_meta(directory: str) -> Optional[dict]:
    """The directory's meta.json, or None when there is none."""
    try:
        with open(os.path.join(directory, META)) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return None


def load_feature_store(
    dataroot: str, name: str, adaptive: bool, relation_type, mmap: bool = False,
) -> FeatureStore:
    """The split's converted tables. ``relation_type`` is one type or an
    iterable of them (an ensemble's members): the semantic table loads for
    'semantic', the file's spatial labels for 'spatial'. Raises, naming the
    converter's command, when the directory is missing or incomplete."""
    needed = {relation_type} if isinstance(relation_type, str) else set(relation_type)
    directory = converted_dir(dataroot, name, adaptive)
    meta = read_meta(directory)
    if meta is None or meta.get("version") != META_VERSION:
        raise FileNotFoundError(
            f"{directory}: no converted copy of {hdf5_path(dataroot, name, adaptive)} "
            f"(its {META} is missing or of another version). Convert it once where h5py "
            f"is installed: {convert_command(dataroot, name)}"
        )

    def load(key: str, lazy: bool = False) -> np.ndarray:
        want = meta["arrays"].get(key)
        rerun = (f"its {META} says {want} — an incomplete conversion. Run it again: "
                 f"{convert_command(dataroot, name)}")
        try:
            arr = np.load(os.path.join(directory, key + ".npy"), mmap_mode="r" if lazy else None)
        except (OSError, ValueError) as e:
            raise FileNotFoundError(f"{directory}: {key}.npy is unreadable, {rerun}") from e
        if want is None or [list(arr.shape), str(arr.dtype)] != [want["shape"], want["dtype"]]:
            raise FileNotFoundError(
                f"{directory}: {key}.npy is {arr.dtype}{list(arr.shape)}, {rerun}")
        return arr

    arrays = meta["arrays"]
    return FeatureStore(
        adaptive=adaptive,
        features=load("image_features", mmap),
        normalized_bb=load("spatial_features"),
        bb=load("image_bb"),
        pos_boxes=load("pos_boxes") if adaptive else None,
        semantic_adj=(load("semantic_adj_matrix")
                      if "semantic_adj_matrix" in arrays and "semantic" in needed else None),
        spatial_adj=(load("image_adj_matrix")
                     if "image_adj_matrix" in arrays and "spatial" in needed else None),
    )


def load_imgid2idx(dataroot: str, name: str, adaptive: bool) -> Dict[int, int]:
    path = os.path.join(dataroot, "imgids", "%s_imgid2idx.pkl" % split_stem(name, adaptive))
    with open(path, "rb") as fh:
        return pickle.load(fh)


@dataclass
class VQADataset:
    """One split, ready to batch: entries, features, answer vocabulary.

    ``ntoken`` is snapshotted at tokenization time: the TF-IDF init later
    extends the shared dictionary, but the questions were padded with the
    pre-extension padding_idx and the model's embedding is sized to it (the
    reference builds the model before extending, reference main.py:128-136)."""

    name: str
    entries: EntryTable
    store: FeatureStore
    num_ans: int
    label2ans: List[str]
    dictionary: Dictionary
    relation_type: str
    ntoken: int = -1

    def __post_init__(self):
        if self.ntoken < 0:
            self.ntoken = self.dictionary.ntoken

    @property
    def padding_idx(self) -> int:
        return self.ntoken  # == padding_idx at tokenization time

    @property
    def v_dim(self) -> int:
        return self.store.v_dim

    def __len__(self) -> int:
        return len(self.entries)


def load_vqa_dataset(
    name: str,
    dictionary: Dictionary,
    relation_type: str,
    dataroot: str = "data",
    adaptive: bool = False,
    mmap: bool = False,
    store_relation_types=None,
) -> VQADataset:
    """``store_relation_types`` (default {relation_type}) widens which
    adjacency tables the store loads: an ensemble needs every member's."""
    assert name in ("train", "val", "test-dev2015", "test2015")
    with open(os.path.join(dataroot, "cache", "trainval_ans2label.pkl"), "rb") as fh:
        ans2label = pickle.load(fh)
    with open(os.path.join(dataroot, "cache", "trainval_label2ans.pkl"), "rb") as fh:
        label2ans = pickle.load(fh)
    img_id2idx = load_imgid2idx(dataroot, name, adaptive)
    store = load_feature_store(dataroot, name, adaptive, store_relation_types or relation_type,
                               mmap)
    entries = load_entries(dataroot, name, img_id2idx, label2ans, dictionary)
    return VQADataset(
        name=name,
        entries=entries,
        store=store,
        num_ans=len(ans2label),
        label2ans=label2ans,
        dictionary=dictionary,
        relation_type=relation_type,
    )
