"""batch_fill.serve: questions per engine call over the fixed batch size the
call ran at, over the whole window, in percent (counted by the harness's
wrapper around the engine instance's infer and step)."""


def read(rec):
    fill = rec.counters.get("batch_fill")
    return None if fill is None else 100.0 * fill
