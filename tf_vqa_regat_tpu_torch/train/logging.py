"""Text and JSONL logging in the JAX package's format (counterpart of
tf_vqa_regat_tpu/train/logging.py): `Logger` appends to `{output}/log.txt`
and prints, `MetricsWriter` appends one JSON record per epoch, `time_since`
as the reference's utils.py has it. Under a process group only rank 0
writes the files (the ranks share one output directory and hold the same
metrics); every rank prints."""

from __future__ import annotations

import json
import math
import os
import time

from tf_vqa_regat_tpu_torch.parallel.distributed import is_primary


def as_minutes(s: float) -> str:
    m = math.floor(s / 60)
    return "%dm %ds" % (m, s - m * 60)


def time_since(since: float, percent: float) -> str:
    s = time.time() - since
    es = s / max(percent, 1e-9)
    return "%s (remain %s)" % (as_minutes(s), as_minutes(es - s))


class Logger:
    def __init__(self, output_name: str):
        self.log_file = None
        if is_primary():
            dirname = os.path.dirname(output_name)
            if dirname:
                os.makedirs(dirname, exist_ok=True)
            self.log_file = open(output_name, "a")

    def write(self, msg: str) -> None:
        if self.log_file is not None:
            self.log_file.write(msg + "\n")
            self.log_file.flush()
        print(msg, flush=True)

    def close(self) -> None:
        if self.log_file is not None:
            self.log_file.close()


class MetricsWriter:
    def __init__(self, path: str):
        self.fh = open(path, "a") if is_primary() else None

    def write(self, record: dict) -> None:
        if self.fh is None:
            return
        self.fh.write(json.dumps(dict(record, ts=time.time())) + "\n")
        self.fh.flush()

    def close(self) -> None:
        if self.fh is not None:
            self.fh.close()
