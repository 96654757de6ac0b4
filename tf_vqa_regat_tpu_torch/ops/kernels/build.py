"""Build a CUDA source of this package into a shared library and load it.

Each `.cu` file under `tf_vqa_regat_tpu_torch/csrc/` has a plain C interface
(no PyTorch headers), so `nvcc` builds it in seconds. The library goes into
`tf_vqa_regat_tpu_torch/_build/` (git-ignored), named by a hash of the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded. The build runs at first use, inside the call that launches a kernel:
nothing here runs at import time, and the CPU tests never reach it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# sm_90a: Hopper with its architecture-specific instructions. No
# --use_fast_math: the kernels take sin/cos of arguments up to ~700 rad.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH); the "
            "package's kernels are built from source at first use"
        )
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: Path) -> Path:
    digest = hashlib.sha1(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile `source` unless its library exists. The compiler's resource
    report (`-Xptxas -v`: registers, shared memory, spills) is kept beside the
    library as `.log`."""
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def load(source: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))
