"""step_mfu.train: the model's training operations per question (counted
from the configuration's shapes, regat_bench/flops.py) times the questions
trained, over the seconds of the untraced train passes times the f32 peak
of the chips used."""

from regat_bench import flops


def read(rec):
    c = rec.counters
    if not c.get("train_seconds"):
        return None
    return flops.mfu_percent(c["train_flops"], c["train_questions"], c["train_seconds"],
                             rec.chips)
