"""BAN's span marks and forward-call counter on the CPU
(models/ban.py, ops/kernels/marks.py):

- an eager BAN train step marks `ban_forward_begin` / `_end` inside each
  microbatch's `forward` and `ban_backward_begin` / `_end` inside its
  `backward`, before B1's backward pairs; an eval block marks the forward
  span per batch and no phase mark; BAN called without a backward that
  reaches its inputs marks no backward span;
- `ban.CALLS` counts train and eval calls apart (its replay through a
  captured graph is tests/test_torch_kernel_launch.py's);
- csrc/marks.cu declares one `regat_span_<name>` kernel per span mark, in
  the module's order at the end of its one table of marks, none named like
  a phase mark, B1 or B2; its launcher's cases follow the table;
- the `[setup]` line of a BAN run names its forward calls.
"""

import re

import pytest
import torch

from regat_bench import kernels
from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.models import ban
from tf_vqa_regat_tpu_torch.models.ban import BAN
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.ops.kernels import build, marks
from tf_vqa_regat_tpu_torch.train.loop import run_training
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
from tf_vqa_regat_tpu_torch.train.step import EvalSteps, TrainSteps

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
V_DIM, NUM_ANS = 24, 7
FORWARD = ["ban_forward_begin", "ban_forward_end"]
BACKWARD = ["ban_backward_begin", "ban_backward_end"]


def _cfg(tmp_path, **kw):
    base = dict(
        num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
        fusion="ban", ban_glimpse=2, relation_type="implicit", residual_connection=True,
        adaptive=True, num_rois=12, epochs=1, batch_size=16, print_freq=100, train_block=1,
        output=str(tmp_path) + "/", save_every_epoch=False,
    )
    base.update(kw)
    return Config(**base)


def _splits():
    train = synthetic_dataset(num_images=8, num_questions=64, v_dim=V_DIM, num_ans=NUM_ANS)
    val = synthetic_dataset(num_images=4, num_questions=16, v_dim=V_DIM, num_ans=NUM_ANS,
                            seed=1)
    return train, val


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_marks_bans_spans_inside_its_phases(tmp_path, grad_accum):
    cfg = _cfg(tmp_path, grad_accum=grad_accum)
    train, _ = _splits()
    model = ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
    opt = Adamax(model, trainable_mask(model, False),
                 make_lr_schedule(cfg.base_lr, 4, cfg.lr_decay_rate, cfg.lr_decay_step),
                 cfg.grad_clip)
    store = DeviceStore(train, CPU, include_adj=False)
    steps = TrainSteps(model, opt, cfg, CPU, store)
    idx = next(store.epoch_indices(0, cfg.batch_size, True, cfg.seed))
    before = ban.CALLS["train"]
    with marks.recording() as names:
        steps.block(cfg.num_rois, idx[None, :], 1)
    b1 = ["b1_backward_begin", "b1_backward_end"] * 2
    assert names == (["gather"] + (["forward"] + FORWARD + ["backward"] + BACKWARD + b1)
                     * grad_accum + ["optimizer", "end"])
    assert ban.CALLS["train"] == before + grad_accum


def test_eval_block_marks_the_forward_span_per_batch(tmp_path):
    cfg = _cfg(tmp_path)
    train, val = _splits()
    model = ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS)
    store = DeviceStore(val, CPU, include_adj=False)
    blk = next(store.epoch_indices(0, 8, False, cfg.seed))[None, :]
    before = (ban.CALLS["train"], ban.CALLS["eval"])
    with marks.recording() as names:
        EvalSteps(model, CPU, store).block(cfg.num_rois, blk)
    assert names == FORWARD
    assert (ban.CALLS["train"], ban.CALLS["eval"]) == (before[0], before[1] + 1)


def test_no_backward_span_without_a_backward_to_the_inputs():
    """Inputs that need no gradient: the module's backward reaches no
    input, so neither backward mark is made (the pair stays whole)."""
    module = BAN(8, 6, 2, torch.Generator().manual_seed(0)).train()
    v, q = torch.randn(2, 5, 8), torch.randn(2, 3, 6)
    mask = torch.ones(2, 5, dtype=torch.bool)
    with marks.recording() as names:
        joint, _ = module(v, q, mask)
        joint.sum().backward()
        joint, _ = module(v.requires_grad_(True), q, mask)
        joint.sum().backward()
    assert names == FORWARD + FORWARD + BACKWARD
    assert v.grad is not None and q.grad is None


def test_span_kernels_are_the_modules_span_marks():
    source = (build.CSRC_DIR / "marks.cu").read_text()
    declared = re.findall(r"__global__ void (regat_span_\w+)\(\)", source)
    assert declared == [marks.SPAN_PREFIX + n for n in marks.SPAN_MARKS]
    listed = re.search(r"kNames\[\] = \{(.*?)\};", source, re.S).group(1)
    assert re.findall(r'"(\w+)"', listed)[-len(declared):] == declared
    # the one launcher's case i launches the table's kernel i
    assert re.findall(r"case (\d+): (\w+)<<<", source) == \
        [(str(i), name) for i, name in enumerate(marks.KERNELS)]
    for name in declared:
        assert not name.startswith(marks.MARK_PREFIX)
        assert not (kernels.is_b1_train(name) or kernels.is_b1_eval(name)
                    or kernels.is_b2(name))
    with pytest.raises(ValueError, match="no phase mark or span mark"):
        marks.mark("ban_forwrd_begin", CPU)


def test_setup_line_of_a_ban_run_names_its_forward_calls(tmp_path):
    cfg = _cfg(tmp_path)
    train, val = _splits()
    run_training(cfg, train, val, ReGAT(cfg, train.ntoken, V_DIM, NUM_ANS), CPU)
    line = next(ln for ln in (tmp_path / "log.txt").read_text().splitlines()
                if ln.startswith("[setup]"))
    assert re.fullmatch(r"\[setup\] model init .*\(0 graphs\); BAN forward calls: "
                        r"train \d+, eval \d+", line), line
