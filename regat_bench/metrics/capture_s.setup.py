"""capture_s.setup: host seconds of the graphs' warm-up and capture, the program's
set-up total `capture` (its train/profiling.py::setup_seconds) at the run's end."""

from regat_bench import phases


def read(rec):
    return phases.setup_seconds("capture")
