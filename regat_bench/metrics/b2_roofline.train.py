"""b2_roofline.train: the least time of one forward call of B2 (the masked
graph attention) at the train batch per chip over its mean device time per
call in the traced train pass, in percent."""

from regat_bench import kernels


def read(rec):
    return kernels.roofline(rec, "train_pass", kernels.is_b2, "b2", train=True)
