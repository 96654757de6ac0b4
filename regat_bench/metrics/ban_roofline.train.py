"""ban_roofline.train: the BAN fusion's least time per train step (its
matrix products without the classifier's, reference/fusion/ban.py::matmuls,
counted for training as flops.train_flops counts them, times the step's
rows, over the f32 peak) over the device-busy time of its forward and
backward spans per step, in percent (regat_bench/spans.py)."""

from regat_bench import spans


def read(rec):
    return spans.ban_roofline(rec)
