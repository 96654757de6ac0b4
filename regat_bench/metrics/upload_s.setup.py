"""upload_s.setup: host seconds of the device stores' tables' upload, the program's
set-up total `upload` (its train/profiling.py::setup_seconds) at the run's end."""

from regat_bench import phases


def read(rec):
    return phases.setup_seconds("upload")
