"""step_mfu.eval: the model's forward operations per question times the
questions evaluated, over the seconds of the untraced eval passes times the
f32 peak."""

from regat_bench import flops


def read(rec):
    c = rec.counters
    if not c.get("eval_seconds"):
        return None
    return flops.mfu_percent(c["eval_flops"], c["eval_questions"], c["eval_seconds"],
                             rec.chips)
