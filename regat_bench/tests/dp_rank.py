"""One rank of a data-parallel cell on the CPU (gloo) at a small size, for
test_bench_dp.py: python -m regat_bench.tests.dp_rank RANK WORLD PORT
[FAULT], FAULT one of no_exchange (the all-reduce of the summed gradients
left out), unchanged (a step that leaves the parameters as they are), half
(each rank's step on the first half of its rows). Rank 0 prints the result
line."""

import json
import os
import sys
import time


def main() -> int:
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    fault = sys.argv[4] if len(sys.argv) > 4 else ""
    os.environ.update(REGAT_COORDINATOR=f"127.0.0.1:{port}", REGAT_NUM_PROCESSES=str(world),
                      REGAT_PROCESS_ID=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    import torch

    from regat_bench import run
    from regat_bench.tests import small
    from tf_vqa_regat_tpu_torch.parallel import distributed
    from tf_vqa_regat_tpu_torch.train import optim as optim_mod
    from tf_vqa_regat_tpu_torch.train import step as step_mod

    torch.set_num_threads(1)
    if fault == "no_exchange":  # the train step's all-reduce of the summed gradients
        class NoExchange:
            def __getattr__(self, name):
                return getattr(distributed, name)

            @staticmethod
            def all_reduce_(tensors, op="sum", group=None):
                pass

        step_mod.distributed = NoExchange()
    elif fault == "unchanged":
        def no_update(self, grads):
            self.count += 1  # the step counts, and nothing moves

        optim_mod.Adamax.step = no_update
    elif fault == "half":
        real = step_mod.grad_sums

        def half(model, params, batch, *a, **k):
            B = batch["features"].shape[0]
            return real(model, params, {key: v[: B // 2] for key, v in batch.items()}, *a, **k)

        step_mod.grad_sums = half
    elif fault:
        raise ValueError(f"no fault {fault!r}")
    distributed.maybe_initialize("cpu")
    args = run.parse(["--workload", "butd.train.dp4", "--seed", "77", "--seconds", "1",
                      "--pending"])
    mix = dict(small.MIXES["train_epoch"])
    mix["program"] = dict(mix["program"], data_mode="sharded")
    ctx = run.context(args, torch.device("cpu"), time.time(), small.CONFIG, mix)
    res = run.execute(ctx, args)
    distributed.destroy()
    if res is not None:
        print(json.dumps({"correct": res["correct"], "checks": res["checks"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
