"""init_s.setup: host seconds of ReGAT's construction on the host, the program's
set-up total `init` (its train/profiling.py::setup_seconds) at the run's end."""

from regat_bench import phases


def read(rec):
    return phases.setup_seconds("init")
