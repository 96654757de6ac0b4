"""b1_roofline.train: the least time of one call of B1's train variant
(regat_bench/flops.py::b1_cost at the train batch per chip) over its mean
device time per call in the traced train pass, in percent."""

from regat_bench import kernels


def read(rec):
    return kernels.roofline(rec, "train_pass", kernels.is_b1_train, "b1", train=True)
