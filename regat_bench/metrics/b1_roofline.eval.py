"""b1_roofline.eval: the least time of one call of B1's eval variant at the
eval batch over its mean device time per call in the traced eval pass, in
percent."""

from regat_bench import kernels


def read(rec):
    return kernels.roofline(rec, "eval_pass", kernels.is_b1_eval, "b1", train=False)
