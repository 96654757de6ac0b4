#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA kernel of the port from csrc/, one nvcc per source,
     all started together (timed);
  3. B1's eval variant against its plain PyTorch version on the card (with
     the pos-FC output summed in f64, as the kernel sums it; the f32 plain
     version's own difference is printed beside it), at the serve and eval
     shapes (b = 1, 8, 32, 64; R=100, H=16, dh=o=64, n=20,
     P=64), with key masks from random box counts in 10-100, one fully
     masked example and one row whose other heads underflow; max abs
     difference, and per-call times (CUDA events around 10 back-to-back
     calls, median of 25 rounds taken in turns with the plain version); the
     tiling plan used at each b and B1's ptxas report (registers, spills,
     shared memory) for both variants;
  4. B1's train variant at b = 32 and 256 with a uint8 keep-mask: `out` and
     the post-relu pos weights `pwr` against the plain version of 3, two
     launches on the same inputs giving equal bits, then the
     gradients of (out * G).sum() w.r.t. q, k, vw, w_pos and b_pos through
     the `ImplicitAttention` Function (kernel forward, transcribed backward)
     against torch autograd of the plain version; forward and
     forward+backward times, timed as in 3. With `--baseline DIR` (another
     checkout of the repo) the B1 wrapper of DIR, built from DIR's source,
     is timed in turns with this one on the same inputs in 3 and 4;
  5. B2 (both softmax modes: v2's global max, v1's per head) against its
     plain version at b = 1, 8, 32, 256 (R=100, H=16, dh=o=64, n=20), with
     adjacency from the spatial labels of random boxes, an empty adjacency
     row, a fully padded example, a row whose other heads underflow, and the
     bias shared across heads [b, R, 1, n] as well as per head [b, R, H, n];
     times of the kernel, the plain version and, as the library yardstick,
     torch's scaled_dot_product_attention with a float mask on tensors
     already laid out for it; the tiling plan used at each b and the
     kernel's ptxas report (registers, spills, shared memory). With
     `--baseline DIR` the B2 wrapper of DIR, built from DIR's source, is
     timed in turns with this one on the same inputs (v2, shared bias);
  6. B2's gradients: dq, dk, dvw and dbias through the `GraphAttention`
     Function (the kernel forward, which keeps v2's row maxima, and the
     backward kernel) against torch autograd of the plain version at b =
     32, 256, v2 and v1, with the shared and the per-head bias of 5 (its
     rows with every key masked and with underflowing heads), one backward
     launch per call;
  7. one train step at the full widths and b=256 of each of
     configs/butd_vqa.json, spatial_vqa.json, semantic_vqa.json, ban_vqa.json
     and mutan_vqa_cp.json (MuTAN twice: per-roi question masks, which take
     the naive Tucker formulation, and `--mutan_shared_qdrop`, which takes
     the reassociated one; the branch taken is checked): loss and per-leaf
     gradients of the kernel path against the plain path (same parameters,
     batch and dropout masks), 2 launches of the family's kernel per
     forward; then the step's split into forward, backward and optimizer
     (CUDA events, median of 10 steps) and its peak device memory; through
     B2, one backward launch per forward launch under grad. The
     spatial batch's edge labels, built on the card, are held to
     build_spatial_graph on the CPU. Then MuTAN's two formulations on one
     full-width eval batch (b=64): logits within MUTAN_BRANCH_RTOL, argmax
     equal, each forward timed;
  8. the entry point, per family (implicit, spatial, semantic with BUTD;
     ban; mutan): `--mode train --synthetic --epochs 1` at the config's
     widths and batch size 256 (6 steps of a 1,536-question synthetic
     split, then an eval pass): finite, falling loss, median
     step time; kernel launches over the run, 2 per forward pass, and none
     of the other relation's kernel; B1's and B2's backward launches, one
     per forward launch under grad;
  9. `--mode eval` on the written .npz: its loss equals the training run's
     last `eval_loss` (metrics.jsonl) to rel 1e-6, 2 launches per pass;
 10. `--mode serve` of that .npz, built by `main.build_server` as the entry
     point builds it, serving HTTP in a thread: /healthz, single and batch
     /predict, an unknown image (404); the launches over those requests must
     be 2 per forward pass (one per direction), and one batch's logits must
     match the same model run with the plain versions;
 11. resume, configs/butd_vqa.json at full width, b=256, `--synthetic
     --epochs 2 --synthetic_train_size 1536 --checkpoint_every_steps 2
     --train_block 2` (6 steps per epoch in blocks of 2, each step a CUDA
     graph replay), through `main.main`: (a) uninterrupted, (a2) the same
     again for the run-to-run spread, (b) with REGAT_FAULT_PREEMPT_STEP=8,
     which must return with meta at epoch 1, step 2 and no final .npz, and
     (c) (b)'s command plus `--resume`, whose final parameters and
     per-epoch metrics must equal (a)'s at RESUME_RTOL / RESUME_ATOL (it
     prints whether they are bit-equal, beside (a2)'s spread) with 2 B1
     train launches per step over its 4 steps; the seconds each save call
     took and waited, and one blocking and one async save of the state;
     whether the word embedding's backward, and the two lookups it chooses
     between, give equal bits call after call;
 12. `--mode predict --checkpoint` on each .npz of 8: the JSON holds every
     question id once, its answers equal the argmax of the plain path's
     logits except for counted ties, 2 launches of the family's kernel per
     pass and none of the other's, and the pass's time;
 13. the ensemble: an implicit member trained here under
     configs/semantic_vqa.json (`--relation_type implicit`, 1 epoch of
     1,536 questions), then `--mode ensemble_eval` of it with 8's spatial
     and semantic .npz under configs/semantic_vqa.json: B1 eval 2 and B2 4
     launches per pass, the score equal to the plain path's and the
     averaged probabilities within ENSEMBLE_PROB_ATOL of it, except for
     counted ties, and the pass's time.
 14. B1 (eval and train variants) and B2 (shared and per-head bias) at R = 36
     and 64 query rows, the roi buckets the JAX bench adds to 100, whose last
     5-row tile is partial: against their plain versions at b = 1, 32, 256
     under the bounds of 3-5, with the degenerate rows of 3 and 5, each
     time beside its plain version, its bound and (B2) SDPA, and both
     wrappers' tiling plans;
 15. the feature tables: the synthetic train split of butd_vqa.json held at
     f32, bf16 and int8, one b=256 batch gathered from each equal bit for
     bit to numpy's widening or dequantization of the same rows; the
     tables' bytes;
 16. one full-width b=256 train step of butd_vqa.json at `--compute_dtype
     bfloat16` against f32 (same parameters, batch and masks): the loss
     within BF16_LOSS_RTOL, each trainable leaf's gradient gap printed;
     the train step's time at R = 36, 64, 100 in both dtypes. Then
     ban_vqa.json, mutan_vqa_cp.json (naive formulation) and with
     `--mutan_shared_qdrop` (reassociated) at bf16, R = 100 and 36: the
     kernel path against the plain path in bf16 (loss within
     BF16_PATH_LOSS_RTOL, each trainable leaf's gradient as BF16_PATH_GRAD
     says, 2 B1 train launches per forward, the formulation checked), the
     bf16-vs-f32 loss and logits gaps, the median step time and the peak
     device memory;
 17. the entry point at the JAX bench's settings (`--feature_dtype bfloat16
     --compute_dtype bfloat16 --roi_buckets 36,64,100`), butd_vqa.json (B1),
     spatial_vqa.json (B2), ban_vqa.json and mutan_vqa_cp.json (B1), each on
     1,536 questions: `--mode train --epochs 1` and `--mode eval`, the launches
     at each bucket R equal to 2 x (its train steps + its eval batches) as
     the store counts them, the median step time per bucket; then, for ban
     and mutan, HTTP serve of the written .npz at those settings (the
     checks of 10, the logits within BF16_PATH_LOGITS_RTOL of the plain
     path's and an answer differing only at a counted tie);
 18. configs/butd_vqa_fixed36.json at b=256: train (1 epoch), eval, serve at
     b = 1, 8, 32 and predict, all at R=36 (the checks of 8-10 and 12),
     with f32 and then int8 feature tables;
 19. real-layout data: a full-width dataset in the reference's on-disk
     layout, its feature files in the converted form, written with numpy
     (`data/synthetic.py::write_dataset`, `write_cp_vg`: train 4,096
     questions over 1,024 images, val 1,024 over 256, test2015 512 over
     128, 10-100 boxes of 2048-d features, 3,129 answers, semantic tables
     and `image_adj_matrix` spatial labels, 1,024 VQA-CP questions per
     split, the Visual Genome files; write time and bytes printed), then
     through the entry point without --synthetic, each with the checks of
     8-10 and 12 (finite losses, the eval loss equal to the run's last, 2
     launches per forward pass): configs/butd_vqa.json train (its --tfidf:
     the dictionary grows, and each word table moves from its GloVe init
     exactly when trainable_mask trains it, `emb_` included), eval, predict
     on the answerless test2015 and HTTP serve on real image ids and an
     unknown one; spatial_vqa.json and semantic_vqa.json train and eval
     through B2, every train batch carrying the file's labels, and one
     b=256 gather of each equal bit for bit to numpy's rows of the
     converted files (features, boxes, `image_adj_matrix` or
     `semantic_adj_matrix`); `--use_both --use_vg` train (train + val + the
     6 VG pairs); mutan_vqa_cp.json (`--dataset vqa_cp`) train and eval;
     `--mmap_features --feature_dtype bfloat16 --packed_cache DIR` train and
     eval twice, the second run a cache hit (no conversion, the cache files
     untouched), with a bf16 gather held to numpy's rounding; the seconds
     of every store build, with and without the cache;
 20. `--grad_accum`: from the same parameters, one f32 step of the
     full-width b=256 model at `--dropout 0` with k = 1, 2, 4 microbatches,
     for butd_vqa.json and mutan_vqa_cp.json (its naive formulation
     forced): the loss, the gradient Adamax receives and the parameters
     after the step against k = 1's (ACCUM_*), 2 k B1 train launches, each
     k's median step time and peak device memory; then butd_vqa.json
     `--mode train --grad_accum 2` with dropout on (phase 11's flags),
     uninterrupted, preempted by REGAT_FAULT_PREEMPT_STEP=8 and resumed:
     the resumed run equal to the uninterrupted one bit for bit, 2 x 2 B1
     train launches per step;
 21. host streaming (data/loader.py, csrc/pack.cc), butd_vqa.json at full
     width, b=256: one batch per --feature_dtype (f32, bf16, int8), packed
     with the C++ and with numpy's row gather (host-clock times, equal
     bytes) and copied pinned to the card (CUDA events, GB/s), equal on the
     card to the device store's gather bit for bit (int8: to the bf16 wire
     batch), and the feature-row gather alone in both versions (GB/s);
     then (a) f32 and (b) bf16 tables and compute: `--mode train --epochs 1`
     and `--mode eval` on 1,536 questions in device mode and in host mode at
     --prefetch 2 and 0, with the checks of 8-9, each host run's parameters
     and metrics equal to the device run's at RESUME_RTOL / RESUME_ATOL
     (bit-equality printed), the median step (CUDA events) and its start-to-
     start period, which holds any wait for the batch; (d) `--data_mode auto
     --device_store_budget_gb 0.05`: the logged resolution is host, `--mode
     eval` gives the device run's eval loss and `--mode predict` device
     mode's answers, `--mode serve` is refused with the budget message; (e)
     spatial_vqa.json `--data_mode host --mmap_features` on 19's dataset
     through B2, every train batch with the file's labels, equal to 19's
     device run; (f) a host run preempted at step 4 and resumed, bit-equal
     to (a)'s host run, with no prefetch thread left, and a device-written
     step checkpoint resumed under host mode refused; (g) 13's ensemble
     over one host stream: 2 B1 and 4 B2 launches per pass, 13's score, and
     batch by batch the averaged probabilities of the host stream within
     ENSEMBLE_PROB_ATOL of the device path's, the batches equal. Each
     batch's pack time is split into the C++ gathers and bf16 rounding
     (without the interpreter lock) and the rest, which holds it; 5,000
     tiny launches are timed alone and while a thread packs.
 22. CUDA graphs (train/graphs.py), through which every step of 8-21 runs:
     (a) from the same seeded parameters, 6 full-width b=256 train steps
     (dropout on) graphed and eager through TrainSteps, bit-equal in
     parameters, Adamax moments, counts and metrics, for butd f32 and bf16
     at R = 36 and 100, spatial at R = 100 and `--grad_accum 2`; then ban
     bf16, `--grad_accum 4` f32 and the host path at bf16, each at R = 36
     and 100; for every row 2 launches of the family's kernel per
     microbatch in both modes (replay-aware counts; through B2 as many
     backward launches), the step time of both
     (host clock over 6 more steps), each graph's warm-up + capture seconds
     and both peak memories; (b) 9's eval pass (eval_block 8) graphed and
     eager: equal score and loss, 2 B1 launches per batch, its time;
     `--mode predict` answers equal; 13's ensemble score equal in both and
     to 13's; serve (b = 1, 8, 32) answers and confidences equal, each
     engine call's time in both.
 23. data parallelism (parallel/, data/sharded_store.py, train/step.py's
     reduced step): (a) one rank over NCCL (REGAT_AUTO_DISTRIBUTED=1 at
     WORLD_SIZE=1, each `main.main` call opening and closing its group):
     butd_vqa.json at full width, b=256, `--data_mode sharded` on 1,536
     questions, train, eval and predict with the checks of 8, 9 and 12;
     then the graphed b=256 step from the same seeded parameters with no
     group and in an NCCL group of one (two graphs and the all-reduce
     between them), in turns, and the all-reduce of the step's buffer (every
     parameter's gradient and 3 sums) alone, its bytes and time; (b) two
     ranks sharing the one card over gloo (NCCL refuses that; gloo stages
     its CUDA collectives through the host), child processes of this script
     that open the group, then call `main.main`: butd_vqa.json at full
     width, b=256 (128 a rank), `--dropout 0 --data_mode device`, 6 steps in
     blocks of 2: the per-epoch metrics against (a'), the same flags at one
     rank with no group, within DP_METRIC_RTOL, both ranks' parameters
     bit-identical (and their distance from (a')'s printed) and equal at
     RESUME_RTOL / RESUME_ATOL to the two ranks' reduced step computed in
     this process (each rank's gradient sums added, then applied); semantic_vqa.json
     `--data_mode sharded` at 2 ranks through B2 with the sharded semantic
     adjacency; the butd run preempted by REGAT_FAULT_PREEMPT_STEP=4 and
     resumed, equal to the uninterrupted one at RESUME_RTOL / RESUME_ATOL;
     every run 2 launches of its kernel per forward pass on each rank; the
     step time and the gloo all-reduce's own time (staged through the host).
 24. tensor parallelism, serve over the sharded store and the sharded
     ensemble (parallel/tensor.py, serve.py, train/ensemble.py): (b) at one
     NCCL rank, 8's butd .npz served by the engine over the sharded store
     (the store policy replaced: at one rank the sharded estimate is the
     replicated one's) and over
     the replicated one, both graphed per batch size: equal answers, logits
     within SERVE_SHARDED_ATOL, 2 B1 launches per forward pass, engine-call
     latency at b = 1 and 32 of both; then two gloo ranks sharing the card
     (child processes, as in 23 (b)): (a) butd and semantic at --tp_size 2
     with 23 (b)'s flags (full widths, b=256, 6 steps in blocks of 2,
     dropout off), then `--mode eval` and `predict` of the written .npz at
     tp = 2, against tp = 1 (23 (b)'s (a') for butd, a run here for
     semantic; eval and predict of the same .npz at tp = 1 here): the train
     loss within TP_METRIC_RTOL and the eval loss of the same weights too
     (the end-of-epoch eval, of weights that 6 Adamax steps moved apart, is
     printed, not held), the replicated leaves bit-identical on the ranks, the
     .npz the ranks' parts put together, the parameters beyond JAX's
     tolerance counted (not held), answers equal outside ties, every B1 and
     B2 launch on all 16 heads, 2 per forward pass per rank, the eager TP
     step's time; butd at tp = 2 preempted at step 4 and resumed at tp = 1,
     its train loss against tp = 1 uninterrupted within TP_METRIC_RTOL; (b) the same engine
     at dp = 2 under a budget only a shard fits: the sharded store on both
     ranks, rank 0 answering what the replicated engine answered, logits
     within SERVE_SHARDED_ATOL on both; (c) 13's ensemble (or, run alone,
     the seed's members) at dp = 2 over the sharded store: every entry
     scored once, averaged probabilities within ENSEMBLE_PROB_ATOL of the
     replicated store's, answers equal outside ties, the score equal; the
     gloo collectives of the b=256 TP step alone (all-gather of Q, the
     all-reduce of the attention input's gradient), host clock. Then the
     control of the tp = 2 gap: butd at tp = 1 in a child process whose
     classifier fc2 product is the sum of its two halves over the input
     dimension (a monkeypatch there, no flag), its end-of-epoch eval-loss
     gap and parameters beyond JAX's tolerance against plain tp = 1
     printed beside tp = 2's.
 25. the reference-quirk switches, --debug_nans and the profilers
     (models/language.py, ops/position.py, train/debug_nans.py,
     train/profiling.py): (a) butd_vqa.json at full width, b=256, with
     --ref_compat_q_att --ref_compat_pos: B1's eval variant (b = 1, 32) and
     train variant (b = 256, gradients through ImplicitAttention) on the
     regrouped position matrix against the plain version at 3-4's bounds;
     `--mode train --epochs 1` on 1,536 questions (falling loss, 2 B1
     launches per forward pass, every step a graph replay), `--mode eval`
     and `--mode predict` of its .npz (8, 9, 12's checks), HTTP serve (10's)
     and engine calls of 3 requests padded to 8 and of 1 against the plain
     path, and 6 steps graphed against eager bit for bit; (b)
     --ref_compat_q_att at dp = 2 on two gloo ranks (23 (b)'s flags): the
     train loss within DP_METRIC_RTOL of the same flags at one rank, the
     ranks bit-identical, the eager reason logged; (c) --debug_nans, butd
     and semantic at full width (23 (b)'s flags): per-epoch losses within
     RESUME_RTOL of the graphed run, the eager reason logged, the eager and
     graphed step times; a run on all-NaN features in a child process must
     raise FloatingPointError naming a module; (d) --profile_dir on a butd
     and a semantic epoch: the `data` and `step` spans, the graph launches
     and the kernels the trace records (B1's and B2's symbols among them),
     the traced epoch's time against the untraced one; (e) --profile_port:
     one GET /capture?duration_ms=500 during a butd run answers with a
     trace file that exists; every step of (c)-(e) but --debug_nans' stays
     a graph replay.
 26. B1's backward kernel (`ImplicitAttention.backward` on the card)
     against `implicit_attention_backward`, the transcription the CPU runs,
     on the same saved `pwr`: R = 100, 64 and 36 at b=256, H = 16 and 8
     (dh=o=64), each with the keep-mask and b_pos and without either, and
     R=100, H=16 at b = 32 and 8, whose plans cut the rows into chunks;
     then the general instance at the other widths the model's flags can
     give (BACKWARD_CASES: 12 heads, dh=128, nongt_dim 36, 50 and 10, roi
     buckets of 16 and 7 below nongt_dim, P = 32 and 96); dq, dk and dvw
     within GRAD_RTOL, dW_pos and db_pos within POS_GRAD_RTOL of their
     largest magnitude, two launches giving equal bits, the train variant's
     row maxima against the plain version's; the device memory one
     backward allocates (its outputs and workspaces, no [b, R, n, P] or
     [b, R, H, n] tensor); times of the kernel against the transcription
     (the specialised instance at b=256 and the general one at its first
     case) and of forward plus backward against autograd of the plain
     version (timed as in 3), and the kernel's bound.
     Then `--mode train` and `--mode eval` of the implicit family at
     OTHER_WIDTHS (8 heads of 128, nongt_dim 12, imp_pos_emb_dim 32), as
     in 8-9. `--only 26` runs 4, 26 and 8-9 for the implicit family (whose
     train runs must count one backward launch per train launch) alone,
     without a result line.
 27. B2's backward kernel (`GraphAttention.backward` on the card) against
     `graph_attention_backward`, the transcription the CPU runs, on the
     same inputs (GRAPH_BACKWARD_CASES): b=256 at R = 100, 64 and 36, v2
     and v1, shared and per-head bias; R=100 at b = 32 and 8, whose plans
     cut the rows into chunks; 8 heads (one head group); then the general
     instance at other widths (12 heads, dh=128, nongt_dim 10 and 7, o=32);
     dq, dk, dvw and dbias within GRAPH_GRAD_RTOL, two launches giving
     equal bits, the forward's row maxima against the plain version's; the
     device memory one backward allocates (its outputs and workspace, no
     [b, R, H, n] tensor); per direction, times of the kernel against the
     transcription at b=256 and R = 100, 64, 36 and for the general
     instance's first case, beside the kernel's bound, and of forward plus
     backward against autograd of the plain version. `--only 27` runs 5,
     6, 27, then 7 and 8-9 for the spatial family, alone, without a result
     line.
 28. Dropout's kernel (`ops/kernels/dropout.py`, `csrc/dropout.cu`): one
     eager train step and one eval step of the benchmark's configurations
     (butd, spatial, ban) at full width, b=256, recording every dropout
     site's layout; per train step the kernel's forward launches must equal
     the sites and its backward launches the sites whose input takes a
     gradient, with none in eval. At every recorded layout (the strided key
     input and the explicit label drop's transposed direction among them)
     and at two tensor-parallel parts of the classifier's draw, in f32 and
     bf16: nn.dropout's output and input gradient inside a CUDA graph
     replayed at two seeds equal the parent's `torch.where` formulation on
     the draw of the same seed bit for bit and in strides, each replay
     adding one launch each way to the counter. Per layout, the kernel's forward and backward
     times against the parent's chain (20 calls captured in one CUDA graph,
     as a graphed step runs them; events around its replays, median of 15
     rounds in turns) and its bound (9 B an element in f32, 5 in bf16, over
     3.35 TB/s), and their sums over a train step's sites. `--only 28` runs
     it alone, without a result line.
Counts of launches are set to 0 just before each path of 8-13, 17-21 and
23-25 (in each rank's process in 23 (b), 24 and 25 (b)) runs and read just after it; the comparison launches of 3-7, 14-16 and 22
and of the plain-path comparisons do not count; B1's backward launches of
those paths, the rank processes' included, must sum to their B1 train
launches (one backward per train forward). Dropout's launches of a path
that trained with dropout on must be, per train microbatch (2 B1 train or
2 B2 backward launches), the dropout sites of its configuration forward
and those whose input takes a gradient backward (an eager step of that
configuration's model on 8 questions, recorded, gives the sites); every
other path, eval, serve, predict and the ensemble among them, launches
none. Every step of 8-21 is a
CUDA graph replay, whose wrapper counts are added per replay (a capture's
are taken back), so a count is the launches the card ran. Each phase prints its wall
time. Phases 8-13 run at the configs' full widths and depths, as before.
Then it prints {"kernels": [...]} (each kernel's time, plain and library
times, and its bound on an H100 SXM: the larger of the bytes it must move
over 3.35 TB/s and its f32 operations over 67 TFLOP/s, from this run's
inputs; the entries named "... R=36" and "... R=64" hold phase 14's numbers
and the launches at that R, the others phases 3-5's at R=100 (B2's
backward 27's) and the launches at every R over the paths of 8-21; dropout's
at the largest butd site, its launches over the paths, by direction, and
phase 28's per train and eval step, and the largest difference phase 28
measured)
and, last, {"ok": true, "device": {...}}.
It imports nothing of JAX and nothing of the JAX package (tf_vqa_regat_tpu).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
# Stated tolerances (f32 throughout; TF32 is switched off below):
# - B1 vs its plain version: log(max(relu(x), 1e-6)) magnifies any rounding
#   of the pos-FC output x, a sum of 64 terms of ~0.2 and a bias that may
#   cancel to just above 1e-6, where an f32 x moves in steps of ~6e-8: two
#   f32 sums one step apart there can move the output by ~1e-2 (on an H100,
#   at b=64, two kernels that summed x in f32 differed from the f32 plain
#   version by 1.3e-3 and 1.4e-2). So the kernel sums x in f64 and rounds it
#   once, and is held to the plain version with that same x
#   (`implicit_reference`); the rest of both is f32 and agrees to ~1e-5.
KERNEL_ATOL = 1e-3
# - logits, kernel path vs plain path through the whole model, relative to
#   the largest |logit| (a random model's logits are ~1e-4): the attention
#   difference passes through the BUTD and classifier matmuls.
LOGITS_RTOL = 1e-3
# - train variant's `pwr` against the reference's: both the f32 nearest the
#   same sum, values O(1).
PWR_ATOL = 1e-4
# - gradients of B1, Function (kernel forward + transcribed backward) vs
#   autograd of the plain version, relative to each tensor's largest
#   magnitude: dq, dk, dvw follow the weights (KERNEL_ATOL above); dW_pos and
#   db_pos divide by pwr, which magnifies the forward's difference wherever
#   pwr sits just above its 1e-6 floor.
GRAD_RTOL = 1e-3
POS_GRAD_RTOL = 1e-2
# - B2 vs its plain version, relative to the largest |output|: the same
#   64-term dots summed in another order; no log or clamp magnifies them.
GRAPH_RTOL = 1e-4
# - B2's gradients, Function vs autograd of the plain version, relative to
#   each tensor's largest magnitude: both recompute the weights from the
#   same inputs with plain ops; only the order of the sums differs.
GRAPH_GRAD_RTOL = 1e-4
# - one full-width train step, kernel path vs plain path: the loss, and each
#   trainable leaf's gradient relative to that leaf's largest magnitude.
#   Leaves with a true gradient of zero give rounding noise on both paths,
#   so they are held to the largest gradient of all leaves instead: the
#   leaves trainable_mask freezes (biases feeding a softmax), and biases
#   JAX leaves trainable though the softmax after them cancels them
#   (ZERO_GRAD_LEAVES): the explicit edge-label FC's bias, which adds one
#   constant to every edge key of a row, and in MuTAN's attention the biases
#   that reach the roi softmax only through linear maps, as one constant per
#   glimpse over all rois: att_fusion's output bias, att_linear0's bias and,
#   where the question side is one per example (`--mutan_shared_qdrop`),
#   the visual merge's bias, which meets that side only (sum_r m0_r * b1_r).
#   Their gradients measured ~1e-9 of the largest on the CPU. On an H100 the worst trainable leaf was a
#   pos-FC scale `g` at 6.3e-3 (the 1/pwr magnification of the forward's
#   difference, as for dW_pos above).
LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 2e-2
# - one full-width train step at --compute_dtype bfloat16 against f32 (same
#   parameters, batch and dropout masks): the loss, relative. bf16 keeps 8
#   bits of mantissa (relative rounding 2^-9 ~ 2e-3) on every stored
#   activation, through ~10 roundings deep.
BF16_LOSS_RTOL = 2e-2
ZERO_GRAD_LEAVES = ("v_relation.gatt.bias.layers.0.b", "joint_emb.att_fusion.linear_out.b",
                    "joint_emb.att_linear0.layers.0.b")
SHARED_QDROP_ZERO_GRAD_LEAVES = ("joint_emb.att_fusion.merge1.b",)
# with no dropout at all the visual side of MuTAN's attention block meets
# one question side per example, and its input bias too shifts every roi's
# score of a glimpse alike
DROPOUT0_ZERO_GRAD_LEAVES = ("joint_emb.att_fusion.linear1.b",)
# - the same step at --compute_dtype bfloat16 (BAN, MuTAN), kernel path vs
#   plain path: B1's ~1e-5 difference from its plain version (and its
#   transcribed backward's other order of sums) moves bf16 roundings
#   downstream by one unit (2^-8 relative) wherever a value sits near a
#   rounding boundary. The loss, relative; and BF16_PATH_GRAD: each
#   trainable leaf's gradient gap (relative to its largest magnitude; the
#   zero-gradient leaves to the largest of all leaves) within twice the gap
#   bf16 itself puts between that leaf's plain-path gradient and the f32
#   model's, or within one bf16 unit roundoff, whichever is larger: a
#   gradient that sums many rounded terms to a small total (a bias before a
#   softmax) moves by ~10% between two orders of the same sums (measured on
#   the CPU, where both paths run the plain forward).
BF16_PATH_LOSS_RTOL = 1e-3
BF16_PATH_GRAD_FLOOR = 2.0 ** -8
# - served logits at --compute_dtype bfloat16, kernel path vs plain path,
#   relative to the largest |logit|: the same unit flips, through the
#   fusion and the classifier, each rounding to bf16 on its output.
BF16_PATH_LOGITS_RTOL = 2e-2
# - --grad_accum k against k = 1, one f32 step from the same parameters at
#   --dropout 0 (the same batch-mean gradient, its per-example terms summed
#   in another order): the loss, relative; the gradient Adamax receives,
#   element by element within ACCUM_GRAD_RTOL of k = 1's plus
#   ACCUM_GRAD_ATOL of the largest gradient of all leaves, as the JAX
#   package's test holds its accumulated gradient (rtol 1e-4, atol 1e-7;
#   the zero-gradient leaves left out: rounding noise); and the parameters
#   after the step within ACCUM_PARAM_ATOL, as tests/test_torch_grad_accum.py
#   holds them on the CPU, wherever k = 1's gradient exceeds twice the
#   gradients' absolute bound. Adamax's first step moves an element by
#   lr g / (|g| + 1e-8), about lr times the sign of g, so where the sign of
#   g is not determined by the f32 sums (on an H100, 6,181 of 22.7 M
#   elements of butd differed by up to 1.1 lr at k = 2) the two steps may
#   differ by up to 2 lr, which is all that is asked there.
ACCUM_LOSS_RTOL = 1e-5
ACCUM_GRAD_RTOL = 1e-4
ACCUM_GRAD_ATOL = 1e-6
ACCUM_PARAM_ATOL = 1e-5
# - MuTAN's reassociated and naive formulations through the whole model on
#   one eval batch, relative to the largest |logit|: the same 18,000 products
#   per output of the Tucker block summed in another nesting (f32, relative
#   rounding ~1e-6), then the answer block.
MUTAN_BRANCH_RTOL = 1e-4
# - --mode eval on the trained .npz against the training run's last eval.
EVAL_LOSS_RTOL = 1e-6
# - a resumed run against the uninterrupted one (final parameters, per-epoch
#   metrics), as the JAX package's resume tests hold them: both runs do the
#   same operations on the same inputs.
RESUME_RTOL = 1e-6
RESUME_ATOL = 1e-7
# - the ensemble's averaged probabilities, kernel path vs plain path; an
#   example whose top two lie within this of each other is a tie.
ENSEMBLE_PROB_ATOL = 1e-5
# - spatial edge labels built on the card vs build_spatial_graph on the CPU:
#   a label may differ only where its angle, from the function's own f32 sine
#   and cosine, lies within this of a sector boundary (the card's asin/acos
#   may differ from the CPU's by an ulp).
SECTOR_EPS = 1e-5
SERVE_SHAPES = dict(R=100, H=16, dh=64, o=64, n=20, P=64)
FIXED36 = "butd_vqa_fixed36.json"
GRAD_ARGS = ("q", "k", "vw", "w_pos", "b_pos")
KERNEL_ARGS = ("q", "k", "vw", "pos_mat", "w_pos", "b_pos", "key_mask")
CONFIGS = {"implicit": "butd_vqa.json", "spatial": "spatial_vqa.json",
           "semantic": "semantic_vqa.json", "ban": "ban_vqa.json",
           "mutan": "mutan_vqa_cp.json"}
# the families whose relation is implicit, so B1 carries them
B1_FAMILIES = ("implicit", "ban", "mutan")
# H100 SXM peaks (NVIDIA's data sheet): HBM rate, f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def median_ms_interleaved(fns, reps=25, calls=10, warmup=3):
    """Per-call time of each function: CUDA events around `calls`
    back-to-back calls, median over `reps` rounds, the functions taking
    turns round by round."""
    import torch

    for _ in range(warmup):
        for f in fns:
            f()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for i, f in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                f()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / calls)
    return [statistics.median(t) for t in times]


def median_graph_ms(fns, reps=15, calls=20):
    """Per-call device time of each function as a graphed step pays it:
    `calls` calls captured into one CUDA graph per function (after a
    warm-up on the capture stream), CUDA events around each replay, median
    over `reps` rounds, the functions taking turns round by round."""
    import torch

    side = torch.cuda.Stream()
    graphs = []
    for f in fns:
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                f()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                f()
        graphs.append(g)
    return median_ms_interleaved([g.replay for g in graphs], reps=reps, calls=1, warmup=1)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: int, flops: float) -> dict:
    """The least time an H100 SXM could take: bytes over the HBM rate or f32
    operations over the f32 peak, whichever is larger."""
    by_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": moved_bytes, "flops": flops}


# B1's and B2's launch counters (ops/kernels/launch.py) by variant, under the
# names this script prints
VARIANTS = {"b1": {"eval": "B1 eval", "train": "B1 train"},
            "b2": {"v2": "B2", "v1": "B2 per-head"}}


def reset_counts() -> None:
    from tf_vqa_regat_tpu_torch.ops.kernels import launch

    for kernel in (*VARIANTS, "dropout"):
        launch.counter(kernel).clear()


def counts() -> dict:
    from tf_vqa_regat_tpu_torch.ops.kernels import launch

    return {name: sum(n for (v, _), n in launch.counter(kernel).items() if v == variant)
            for kernel, names in VARIANTS.items() for variant, name in names.items()}


def rows_counts() -> dict:
    """The launches since reset_counts() by (kernel, query rows R), with the
    names of `counts()`, zero entries left out."""
    from tf_vqa_regat_tpu_torch.ops.kernels import launch

    return {(names[variant], R): n for kernel, names in VARIANTS.items()
            for (variant, R), n in launch.counter(kernel).items() if variant in names and n}


# the launches by (kernel, R) of every path of 8-21 that records them
PATH_ROWS = []
# B1's backward launches of those paths
PATH_BACKWARD = []
# B2's backward launches of the paths of 8-21 that train through B2
PATH_B2_BACKWARD = []
# the dropout launches of every path that reads its counts (read_path_counts)
PATH_DROPOUT = []
# (sites, sites whose input takes a gradient) of a train microbatch, by
# configuration (dropout_sites), keyed by the fields that shape the model
DROPOUT_SITES = {}
DROPOUT_KEY = ("adaptive", "relation_type", "fusion", "op", "num_hid", "imp_pos_emb_dim",
               "spa_label_num", "sem_label_num", "dir_num", "relation_dim", "nongt_dim",
               "num_heads", "num_steps", "residual_connection", "label_bias", "dropout",
               "ban_glimpse", "mutan_rank", "mutan_gamma", "mutan_shared_qdrop", "num_rois",
               "compute_dtype", "fold_dual_attention", "ref_compat_q_att", "ref_compat_pos")
# the split sizes of check_entry_point's last training run, and its train
# batches that carried edge labels
LAST_TRAIN = {}


# phase 13's member list, score and passes, which phase 21 streams again
LAST_ENSEMBLE = {}


def backward_launches(kernel: str) -> int:
    """The backward launches of `kernel` ("b1", "b2") since the last
    reset_counts()."""
    from tf_vqa_regat_tpu_torch.ops.kernels import launch

    return sum(n for (v, _), n in launch.counter(kernel).items() if v == "backward")


def rank_launches(rec, label) -> dict:
    """The launch counts of a rank process's record; its B1 backward launches,
    one per B1 train launch, go to PATH_BACKWARD."""
    if rec["backward"] != rec["launches"]["B1 train"]:
        fail(f"{label}: {rec['backward']} B1 backward launches for "
             f"{rec['launches']['B1 train']} train launches")
    PATH_BACKWARD.append(rec["backward"])
    return rec["launches"]


def dropout_sites(cfg) -> tuple:
    """(the dropout sites one train microbatch of `cfg`'s model draws, those
    whose input takes a gradient): one eager train step of the model at
    cfg's widths on 8 synthetic questions, recorded by `recorded_dropouts`
    and held to the kernel's launches; kept per configuration. Every
    counter and the random state are as they were after it."""
    import torch

    from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
    from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT
    from tf_vqa_regat_tpu_torch.ops.kernels import launch
    from tf_vqa_regat_tpu_torch.train.step import train_forward

    key = tuple(getattr(cfg, f) for f in DROPOUT_KEY)
    if key in DROPOUT_SITES:
        return DROPOUT_SITES[key]
    device = torch.device("cuda")
    saved, drops, sites = launch.counts(), launch.counter("dropout"), []
    drops.clear()
    try:
        with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
            ds = synthetic_dataset(num_images=4, num_questions=8, v_dim=64, num_ans=16,
                                   semantic=cfg.relation_type == "semantic",
                                   adaptive=cfg.adaptive)
            store = DeviceStore(ds, device)
            idx = next(store.epoch_indices(0, 8, True, cfg.seed))
            batch = gather_batch(store, torch.from_numpy(idx).to(device),
                                 cfg.resolved_num_rois())
            model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device)
            with recorded_dropouts(sites):
                loss, _ = train_forward(model, batch, 0, cfg.seed)
                torch.autograd.grad(loss, list(model.parameters()))
        got = (drops["forward"], drops["backward"])
    finally:
        launch.set_counts(saved)
    want = (len(sites), sum(s["grad"] for s in sites))
    if got != want:
        fail(f"dropout: an eager step of {cfg.fusion}/{cfg.relation_type} launched {got} "
             f"(forward, backward) for {want} sites (all, with a gradient)")
    DROPOUT_SITES[key] = want
    return want


def dropout_launches() -> dict:
    """The dropout kernel's launches since the last reset_counts()."""
    from tf_vqa_regat_tpu_torch.ops.kernels import launch

    return {k: launch.counter("dropout")[k] for k in ("forward", "backward")}


def read_path_counts(cfg=None) -> dict:
    """counts() of the path that just ran; its launches by R go to PATH_ROWS,
    its B1 backward launches to PATH_BACKWARD, and its dropout launches,
    held to the path's train microbatches, to PATH_DROPOUT. `cfg`: the
    configuration the path trained, whose every microbatch (2 B1 train
    launches, or 2 B2 backward launches) must launch the kernel forward at
    each of its dropout sites and backward at each whose input takes a
    gradient; without it the path trained nothing with dropout, and
    launched none."""
    PATH_ROWS.append(rows_counts())
    PATH_BACKWARD.append(backward_launches("b1"))
    PATH_B2_BACKWARD.append(backward_launches("b2"))
    launches = counts()
    got = dropout_launches()
    micro = (launches["B1 train"] + PATH_B2_BACKWARD[-1]) // 2
    sites, grads = (0, 0) if cfg is None else dropout_sites(cfg)
    want = {"forward": sites * micro, "backward": grads * micro}
    if got != want:
        fail(f"dropout launches {got} for {micro} train microbatches of "
             f"{sites} sites ({grads} with a gradient): want {want}")
    PATH_DROPOUT.append(dict(got, microbatches=micro if sites else 0))
    return launches


@contextlib.contextmanager
def phase(name):
    """Print the wall time of the block as `phase <name>: <s> s`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s wall", flush=True)


@contextlib.contextmanager
def mutan_branches(force_naive=False):
    """Record the Tucker formulation each MuTAN block runs (a list of
    names); with `force_naive` the reassociated one is replaced by the
    naive one on the same inputs."""
    from tf_vqa_regat_tpu_torch.models.mutan import MutanBlock

    real = {n: getattr(MutanBlock, n) for n in ("naive", "reassociated")}
    taken = []

    def spy(name):
        def run(self, h0, h1):
            taken.append(name)
            return real["naive" if force_naive else name](self, h0, h1)
        return run

    for name in real:
        setattr(MutanBlock, name, spy(name))
    try:
        yield taken
    finally:
        for name, fn in real.items():
            setattr(MutanBlock, name, fn)


@contextlib.contextmanager
def plain_kernels():
    """The model's attention through the plain PyTorch versions (autograd
    differentiates them), for the kernel path vs plain path comparisons."""
    from tf_vqa_regat_tpu_torch.ops import graph_attention
    from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga
    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    graph_attention.fused_implicit_graph_attention = ia.implicit_attention_plain
    graph_attention.fused_graph_attention = ga.graph_attention_plain
    try:
        yield
    finally:
        graph_attention.fused_implicit_graph_attention = ia.fused_implicit_graph_attention
        graph_attention.fused_graph_attention = ga.fused_graph_attention


def kernel_inputs(b, device, seed, R=SERVE_SHAPES["R"], position=None, H=SERVE_SHAPES["H"],
                  widths=None):
    """Serve-shaped inputs for one direction of the implicit attention, at
    R query rows (box counts min(10, R)-R), H heads and SERVE_SHAPES' widths
    but those in `widths`, the position matrix by `position` (default
    ops/position.py::position_matrix)."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.position import position_matrix

    position = position or position_matrix

    s = {**SERVE_SHAPES, **(widths or {})}
    dh, o, n, P = s["dh"], s["o"], s["n"], s["P"]
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=device)

    xy = torch.rand(b, R, 2, generator=g, device=device) * 450
    wh = torch.rand(b, R, 2, generator=g, device=device) * 190 + 4
    num_boxes = torch.randint(min(10, R), R + 1, (b,), generator=g, device=device)
    if b > 1:
        num_boxes[-1] = 0  # a padded serve slot: every key masked
    q = randn(b, R, H, dh)
    k = randn(b, n, H, dh)
    # one row whose head 0 outscores every other head by ~500: those heads
    # underflow against the row max and must get all-zero weights
    k[0, :, 0, :] = 8.0
    q[0, min(7, R - 1), 0, :] = 8.0
    return dict(
        q=q, k=k, vw=randn(b, n, H, o),
        pos_mat=position(torch.cat([xy, xy + wh], -1), n).contiguous(),
        w_pos=randn(P, H, scale=0.2), b_pos=randn(H, scale=0.5),
        key_mask=torch.arange(n, device=device)[None, :] < num_boxes[:, None],
    )


def implicit_reference(q, k, vw, pos_mat, w_pos, b_pos, key_mask, drop_rate=0.0,
                       dropmask=None, save_pwr=False):
    """B1's plain version with its pos-FC output summed in float64 and
    rounded once to f32, as the kernel sums it; the rest, the sinusoid
    embedding included, is the plain version's f32 code."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    f64 = torch.float64
    mrow, b_vec, keep, inv_keep = ia._prepare(
        q.shape[2], b_pos, key_mask, drop_rate, dropmask, q.device)
    pe = ia._embedding(pos_mat, w_pos.shape[0], keep, inv_keep)
    x = torch.einsum("brnp,ph->brhn", pe.to(f64), w_pos.to(f64)) + b_vec.to(f64)[:, None]
    pwr = torch.relu(x.float())
    out = torch.einsum("brhn,bnho->brho", ia._weights(q, k, pwr, mrow), vw)
    return (out, pwr) if save_pwr else out


def implicit_flops(b, R=SERVE_SHAPES["R"]):
    """f32 operations of one B1 call: per (row, head, key) the q.k dot, the
    pos-FC dot and the weighted sum of vw."""
    s = SERVE_SHAPES
    return 2.0 * b * R * s["H"] * s["n"] * (s["dh"] + s["P"] + s["o"])


def implicit_plan(b, R=SERVE_SHAPES["R"]):
    """B1's tiling plan at the serve shapes, R rows and batch b, as a dict."""
    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    s = SERVE_SHAPES
    return ia.tiling_plan(b, R, s["n"], s["H"], s["dh"], s["o"], s["P"])._asdict()


def check_kernels(device, resources, baseline=None):
    """Kernel vs plain at b = 1, 8, 32, 64. Returns per-b rows. `baseline`:
    another checkout's B1 module, timed in turns with this one."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    rows = []
    for b in (1, 8, 32, 64):
        x = kernel_inputs(b, device, seed=b)
        args = [x[k] for k in KERNEL_ARGS]
        got = ia.fused_implicit_graph_attention(*args)
        want = implicit_reference(*args)
        plain_err = (ia.implicit_attention_plain(*args) - want).abs().max().item()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"kernel output not finite at b={b}")
        err = (got - want).abs().max().item()
        zero_heads = got[0, 7, 1:].abs().max().item()
        masked_err = (
            (got[-1] - x["vw"][-1].mean(0)[None]).abs().max().item() if b > 1 else 0.0
        )
        fns = {"ms": lambda: ia.fused_implicit_graph_attention(*args),
               "plain_ms": lambda: ia.implicit_attention_plain(*args)}
        row = dict(b=b, plan=implicit_plan(b), ptxas=resources, max_abs_err=err,
                   plain_err=plain_err, underflow_heads_max=zero_heads,
                   fully_masked_err=masked_err)
        if baseline is not None:
            row["baseline_err"] = (
                baseline.fused_implicit_graph_attention(*args) - want).abs().max().item()
            fns["baseline_ms"] = lambda: baseline.fused_implicit_graph_attention(*args)
        row.update(zip(fns, median_ms_interleaved(list(fns.values()))))
        row.update(bound(nbytes(*args, got), implicit_flops(b)))
        print("kernel implicit_attention", json.dumps(row), flush=True)
        if err > KERNEL_ATOL:
            fail(f"kernel vs plain max abs diff {err} > {KERNEL_ATOL} at b={b}")
        if zero_heads != 0.0:
            fail(f"underflowing heads are not zero at b={b}: {zero_heads}")
        if masked_err > KERNEL_ATOL:
            fail(f"fully masked example is not uniform at b={b}: {masked_err}")
        rows.append(row)
    return rows


def max_rel(got, want):
    """Largest |got - want| over the largest |want|."""
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def check_train_kernel(device, resources, baseline=None):
    """B1's train variant and the Function's gradients vs the plain version
    at b = 32 and 256, drop rate 0.2, and two launches' bits at each b.
    Returns per-b rows. `baseline`: another checkout's B1 module, timed in
    turns with this one."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    s = SERVE_SHAPES
    rows = []
    for b in (32, 256):
        x = kernel_inputs(b, device, seed=100 + b)
        g = torch.Generator(device=device).manual_seed(b)
        bits = torch.randint(0, 256, (b, s["R"], s["n"], s["P"]), generator=g,
                             device=device, dtype=torch.uint8)
        dropmask = (bits >= 51).view(torch.uint8)  # keep-mask at rate 51/256
        G = torch.randn(b, s["R"], s["H"], s["o"], generator=g, device=device)

        def fwd_bwd(fn):
            leaves = {k: x[k].clone().requires_grad_() for k in GRAD_ARGS}
            out = fn(*(leaves.get(k, x[k]) for k in KERNEL_ARGS), 0.2, dropmask)
            grads = torch.autograd.grad((out * G).sum(), [leaves[k] for k in GRAD_ARGS])
            return out.detach(), dict(zip(GRAD_ARGS, grads))

        args = [x[k] for k in KERNEL_ARGS] + [0.2, dropmask]
        with torch.no_grad():
            out_k, pwr_k, _ = ia.KERNEL(*args, save_pwr=True)
            out_p, pwr_p = implicit_reference(*args, save_pwr=True)
            out_32, pwr_32 = ia.implicit_attention_plain(*args, save_pwr=True)
            # determinism: a second launch on the same inputs gives equal bits
            out_2, pwr_2, _ = ia.KERNEL(*args, save_pwr=True)
        fout_k, grads_k = fwd_bwd(ia.fused_implicit_graph_attention)  # the Function
        fout_p, grads_p = fwd_bwd(ia.implicit_attention_plain)
        torch.cuda.synchronize()
        for name, t in [("out", out_k), ("pwr", pwr_k), *grads_k.items()]:
            if not torch.isfinite(t).all():
                fail(f"train variant: {name} not finite at b={b}")
        err = {
            "out": (out_k - out_p).abs().max().item(),
            "pwr": (pwr_k - pwr_p).abs().max().item(),
            "plain_out": (out_32 - out_p).abs().max().item(),
            "plain_pwr": (pwr_32 - pwr_p).abs().max().item(),
            "function_out": (fout_k - out_k).abs().max().item(),
            **{f"d{k}": max_rel(grads_k[k], grads_p[k]) for k in GRAD_ARGS},
        }
        db = (grads_k["b_pos"] - grads_p["b_pos"]).abs()
        err["db_pos_worst_head"] = int(db.argmax())
        same_bits = bool(torch.equal(out_k, out_2) and torch.equal(pwr_k, pwr_2))
        fns = {"fwd_ms": lambda: ia.KERNEL(*args, save_pwr=True),
               "fwd_plain_ms": lambda: ia.implicit_attention_plain(*args, save_pwr=True)}
        extra = {}
        with torch.no_grad():
            if baseline is not None:
                out_b, pwr_b = baseline.KERNEL(*args, save_pwr=True)[:2]
                extra["baseline_err"] = max((out_b - out_p).abs().max().item(),
                                                 (pwr_b - pwr_p).abs().max().item())
                fns["baseline_fwd_ms"] = lambda: baseline.KERNEL(*args, save_pwr=True)
            extra.update(zip(fns, median_ms_interleaved(list(fns.values()))))
        bwd_ms, bwd_plain_ms = median_ms_interleaved(
            [lambda: fwd_bwd(ia.fused_implicit_graph_attention),
             lambda: fwd_bwd(ia.implicit_attention_plain)], reps=21, calls=3,
        )
        moved = nbytes(*(x[k] for k in KERNEL_ARGS), dropmask, out_k, pwr_k)
        row = dict(b=b, plan=implicit_plan(b), ptxas=resources, **err,
                   equal_bits_twice=same_bits, **extra, fwd_bwd_ms=bwd_ms,
                   fwd_bwd_plain_ms=bwd_plain_ms, **bound(moved, implicit_flops(b)))
        print("kernel implicit_attention train", json.dumps(row), flush=True)
        if not same_bits:
            fail(f"train variant: two launches on the same inputs differ at b={b}")
        limits = [("out", KERNEL_ATOL), ("pwr", PWR_ATOL), ("function_out", 0.0),
                  ("dq", GRAD_RTOL), ("dk", GRAD_RTOL), ("dvw", GRAD_RTOL),
                  ("dw_pos", POS_GRAD_RTOL), ("db_pos", POS_GRAD_RTOL)]
        for name, tol in limits:
            if not err[name] <= tol:
                fail(f"train variant: {name} differs by {err[name]} > {tol} at b={b}")
        rows.append(row)
    return rows


def implicit_bwd_flops(b, R=SERVE_SHAPES["R"], H=SERVE_SHAPES["H"], n=SERVE_SHAPES["n"],
                       dh=SERVE_SHAPES["dh"], P=SERVE_SHAPES["P"]):
    """f32 operations of one B1 backward: per (row, head, key) the q.k and
    g.vw dots rebuilt, the dq and dk sums, the dvw sum and the dW_pos sum."""
    return 2.0 * b * R * H * n * (5 * dh + P)


# phase 26's cases: (b, R, H, keep-mask and b_pos, widths other than the
# model's); those with other widths, or 12 heads, run the general instance
BACKWARD_CASES = tuple((256, R, H, full, {}) for R in (100, 64, 36) for H in (16, 8)
                       for full in (True, False)) + (
    (32, 100, 16, True, {}), (8, 100, 16, True, {}),
    (64, 100, 12, True, {}),  # 12 heads of 64: 4 heads a block
    (64, 100, 8, True, dict(dh=128, o=128)),  # relation_dim 1024 over 8 heads
    (64, 100, 8, True, dict(n=36)),  # --nongt_dim 36 over 8 heads: 4 heads a block
    (64, 100, 4, True, dict(n=50)),  # --nongt_dim 50 over 4 heads: 2 heads a block
    (64, 36, 16, False, dict(n=10)),  # --nongt_dim 10: keys not a multiple of 4
    (64, 16, 16, True, dict(n=16)),  # a roi bucket of 16 under nongt_dim 20: n = R
    (64, 7, 16, True, dict(n=7)),  # a roi bucket of 7: n = R = 7
    (64, 100, 16, True, dict(P=32)),  # --imp_pos_emb_dim 32
    (32, 36, 4, True, dict(dh=32, o=32, P=96)),  # P = 96: 6 sets of dW_pos warps, 4 idle
)


def backward_resources(module, kernel, modes=("",)) -> dict:
    """A backward kernel's ptxas report: its specialised instance and its
    general one (template arguments 0), in each softmax mode of `modes`
    (B2's " v2" and " v1", the `<..., false>` and `<..., true>` instances;
    B1's backward has one)."""
    from tf_vqa_regat_tpu_torch.ops.kernels import build

    report = ptxas_report(build.library_path(module.SOURCE).with_suffix(".log").read_text())
    found = {}
    for name, res in report.items():
        if kernel in name:
            kind = "general" if "ILi0ELi0ELi0ELi0E" in name else "specialised"
            found[kind + modes["Lb1E" in name]] = {"static_smem": 0, **res}
    if set(found) != {k + m for k in ("general", "specialised") for m in modes}:
        fail(f"no ptxas report for every instance of {kernel}: {sorted(report)}")
    return found


def check_backward_kernel(device):
    """Phase 26: B1's backward kernel against implicit_attention_backward on
    the same saved pwr. Returns per-case rows; the first (b=256, R=100,
    H=16, keep-mask and b_pos) carries the memory check and the times, and
    the first case of the general instance its times."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    names = ("dq", "dk", "dvw", "dw_pos", "db_pos")
    rows, general_timed = [], False
    for i, (b, R, H, full, widths) in enumerate(BACKWARD_CASES):
        s = {**SERVE_SHAPES, **widths}
        n, dh, P = s["n"], s["dh"], s["P"]
        x = kernel_inputs(b, device, seed=300 + i, R=R, H=H, widths=widths)
        if not full:
            x["b_pos"] = None
        g = torch.Generator(device=device).manual_seed(400 + i)
        rate, dropmask = 0.0, None
        if full:
            bits = torch.randint(0, 256, (b, R, n, P), generator=g, device=device,
                                 dtype=torch.uint8)
            rate, dropmask = 0.2, (bits >= 51).view(torch.uint8)  # keep-mask at rate 51/256
        G = torch.randn(b, R, H, s["o"], generator=g, device=device)
        args = [x[k] for k in KERNEL_ARGS] + [rate, dropmask]
        with torch.no_grad():
            _, pwr, rowmax = ia.KERNEL(*args, save_pwr=True)
        mrow, _, keep, inv_keep = ia._prepare(H, x["b_pos"], x["key_mask"], rate, dropmask,
                                              device)
        core = (x["q"], x["k"], x["vw"], x["pos_mat"])

        def kernel():
            return ia.KERNEL.backward(G, *core, mrow, keep, inv_keep, pwr, rowmax, P)

        def transcription():
            return ia.implicit_attention_backward(G, *core, x["w_pos"], mrow, keep, inv_keep,
                                                  pwr)

        plan = ia.backward_plan(b, R, n, H, dh, s["o"], P)
        general = (plan.heads, n, dh, P) not in ia.BWD_SPECIALISED
        got, again, want = kernel(), kernel(), transcription()
        torch.cuda.synchronize()
        where = f"b={b}, R={R}, H={H}, widths {widths}"
        for name, t in zip(names, got):
            if not torch.isfinite(t).all():
                fail(f"B1 backward: {name} not finite at {where}")
        # the row max the backward rebuilds the weights against, vs the plain
        # version's affinities from the same pwr (absolute, in the examples
        # with a key: a fully masked one's max is -9e15)
        bias = torch.log(torch.clamp(pwr, min=1e-6)) + mrow[:, None, None, :]
        aff = torch.einsum("brhd,bnhd->brhn", x["q"], x["k"]) / math.sqrt(dh) + bias
        valid = x["key_mask"].any(1)
        row = dict(b=b, R=R, H=H, keep_and_b_pos=full, widths=widths, general=general,
                   plan=plan._asdict(),
                   **{m: max_rel(a, w) for m, a, w in zip(names, got, want)},
                   rowmax=(rowmax - aff.amax(dim=(2, 3)))[valid].abs().max().item(),
                   equal_bits_twice=all(torch.equal(a, c) for a, c in zip(got, again)))
        del got, again, want, aff, bias
        if i == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            res = kernel()
            torch.cuda.synchronize()
            row["bwd_peak_bytes"] = torch.cuda.max_memory_allocated(device) - base
            workspace = plan.chunks * b * (P + 1) * H * 8
            row["bwd_outputs_bytes"] = nbytes(*res) + workspace
            row["embedding_bytes"] = b * R * n * P * 4  # one [b, R, n, P] f32
            row["weights_bytes"] = b * R * H * n * 4  # one [b, R, H, n] f32
            del res
            leaves_at = {k: x[k] for k in GRAD_ARGS}

            def fwd_bwd(fn):
                leaves = {k: t.clone().requires_grad_() for k, t in leaves_at.items()}
                out = fn(*(leaves.get(k, x[k]) for k in KERNEL_ARGS), rate, dropmask)
                return torch.autograd.grad((out * G).sum(), list(leaves.values()))

            row["fwd_bwd_ms"], row["fwd_bwd_plain_ms"] = median_ms_interleaved(
                [lambda: fwd_bwd(ia.fused_implicit_graph_attention),
                 lambda: fwd_bwd(ia.implicit_attention_plain)], reps=21, calls=3)
        if i == 0 or general and not general_timed:
            general_timed |= general
            row["bwd_ms"], row["bwd_transcription_ms"] = median_ms_interleaved(
                [kernel, transcription], reps=21, calls=3)
            moved = nbytes(G, *core, pwr, rowmax, mrow, *(t for t in (keep,) if t is not None),
                           x["q"], x["k"], x["vw"])  # and dq, dk, dvw written
            row.update(bound(moved, implicit_bwd_flops(b, R, H, n, dh, P)))
        print("kernel implicit_attention backward", json.dumps(row), flush=True)
        if not row["equal_bits_twice"]:
            fail(f"B1 backward: two launches on the same inputs differ at {where}")
        limits = [("dq", GRAD_RTOL), ("dk", GRAD_RTOL), ("dvw", GRAD_RTOL),
                  ("dw_pos", POS_GRAD_RTOL), ("db_pos", POS_GRAD_RTOL), ("rowmax", KERNEL_ATOL)]
        for name, tol in limits:
            if not row[name] <= tol:
                fail(f"B1 backward: {name} differs by rel {row[name]} > {tol} at {where}, "
                     f"keep-mask and b_pos {full}")
        if i == 0 and row["bwd_peak_bytes"] > row["bwd_outputs_bytes"] + 2**20:
            fail(f"B1 backward allocated {row['bwd_peak_bytes']} B for "
                 f"{row['bwd_outputs_bytes']} B of outputs and workspace")
        rows.append(row)
    return rows


def graph_inputs(b, device, seed, R=SERVE_SHAPES["R"], H=SERVE_SHAPES["H"], widths=None):
    """Inputs of one direction of B2 at the model's shapes (H heads and the
    widths in `widths` aside) and R query rows
    (box counts 10-R), the bias built
    as the model builds it: spatial labels of random boxes (direction 0),
    a random label bias, non-edges and padded keys at -9e15. Example 0 has
    all 100 boxes; its row 3 has no edge (uniform weights over the valid
    keys), row 7 has every edge and a head 0 that outscores the others by
    ~500 (they underflow), row 9 has every edge in head 0 and none in the
    other heads of the per-head bias. With b > 1 the last example is padded."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.graph_attention import explicit_bias
    from tf_vqa_regat_tpu_torch.ops.kernels.implicit_attention import NEG_INF
    from tf_vqa_regat_tpu_torch.ops.spatial_graph import (
        broadcast_adj_labels,
        build_spatial_graph,
    )

    s = {**SERVE_SHAPES, **(widths or {})}
    dh, o, n = s["dh"], s["o"], s["n"]
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=device)

    num_boxes = torch.randint(10, R + 1, (b,), generator=g, device=device)
    num_boxes[0] = R
    if b > 1:
        num_boxes[-1] = 0
    roi_ok = (torch.arange(R, device=device)[None, :] < num_boxes[:, None])[..., None]
    xy = torch.rand(b, R, 2, generator=g, device=device) * torch.tensor([448.0, 336.0], device=device)
    wh = torch.rand(b, R, 2, generator=g, device=device) * torch.tensor([192.0, 144.0], device=device) + 4
    bb = torch.where(roi_ok, torch.cat([xy, xy + wh], -1), 0.0)
    size = torch.tensor([640.0, 480.0], device=device)
    norm_bb = torch.where(roi_ok, torch.cat([bb / size.repeat(2), (wh + 1) / size], -1), 0.0)
    labels = build_spatial_graph(bb, norm_bb)
    labels[0, 3] = 0
    labels[0, 7, :n] = 4
    labels[0, 9, :n] = 4
    adj_mask = broadcast_adj_labels(labels, 11)[:, :, :n].sum(-1)
    key_mask = torch.arange(n, device=device)[None, :] < num_boxes[:, None]
    shared = explicit_bias(adj_mask, randn(b, R, n, scale=0.5), key_mask)
    per_head = shared + randn(b, R, H, n, scale=0.1)
    per_head[0, 9, 1:] = NEG_INF
    q, k = randn(b, R, H, dh), randn(b, n, H, dh)
    k[0, :, 0, :] = 8.0
    q[0, 7, 0, :] = 8.0
    return dict(q=q, k=k, vw=randn(b, n, H, o), shared=shared, per_head=per_head.contiguous())


def graph_flops(b, R=SERVE_SHAPES["R"]):
    """f32 operations of one B2 call: per (row, head, key) the q.k dot and
    the weighted sum of vw."""
    s = SERVE_SHAPES
    return 2.0 * b * R * s["H"] * s["n"] * (s["dh"] + s["o"])


def ptxas_report(text: str) -> dict:
    """Per kernel entry of an `nvcc -Xptxas -v` log: registers, spill
    stores and loads, static shared memory (bytes)."""
    report, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
            report.setdefault(name, {})
            continue
        if name is None:
            continue
        for key, pattern in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("static_smem", r"(\d+) bytes smem")):
            m = re.search(pattern, line)
            if m:
                report[name][key] = int(m.group(1))
    return report


def kernel_resources(module, kernel, modes) -> dict:
    """A kernel's ptxas report per template instance (`modes`: the names of
    `<false>` and `<true>`), from the log its build left beside the library
    (ptxas names static shared memory only where there is some; the dynamic
    shared memory is the tiling plan's `smem_bytes`)."""
    from tf_vqa_regat_tpu_torch.ops.kernels import build

    report = ptxas_report(build.library_path(module.SOURCE).with_suffix(".log").read_text())
    found = {}
    for name, res in report.items():
        if kernel in name:
            found[modes[1] if "ILb1E" in name else modes[0]] = {"static_smem": 0, **res}
    if set(found) != set(modes):
        fail(f"no ptxas report for {modes} of {kernel}: {sorted(report)}")
    return found


def load_baseline(path, name):
    """The wrapper module `ops/kernels/{name}.py` of another checkout at
    `path` (one whose wrappers load through ops/kernels/launch.py), reading
    and building that checkout's `csrc/{name}.cu` (its own library, named by
    the source's hash; its launches count in this checkout's counters);
    None without `path`."""
    if path is None:
        return None
    from pathlib import Path

    pkg = Path(path).resolve() / "tf_vqa_regat_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        f"baseline_{name}", pkg / "ops" / "kernels" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = mod.LIB.source = pkg / "csrc" / f"{name}.cu"
    mod.LIB.load()
    return mod


def check_graph_kernel(device, resources, baseline=None):
    """B2 in both modes vs its plain version at b = 1, 8, 32, 256, with the
    shared and the per-head bias, and the degenerate rows of graph_inputs.
    Returns per-b rows (times with the shared bias, as the model passes it).
    `baseline`: another checkout's B2 module, timed in turns with this one."""
    import torch
    import torch.nn.functional as F

    from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga

    s = SERVE_SHAPES
    rows = []
    for b in (1, 8, 32, 256):
        x = graph_inputs(b, device, seed=200 + b)
        q, k, vw = x["q"], x["k"], x["vw"]
        plan = ga.tiling_plan(b, s["R"], s["n"], s["H"], s["dh"], s["o"])
        row = dict(b=b, plan=plan._asdict(), ptxas=resources)
        for per_head in (False, True):
            mode = "v1" if per_head else "v2"
            for which in ("shared", "per_head"):
                got = ga.fused_graph_attention(q, k, vw, x[which], per_head)
                want = ga.graph_attention_plain(q, k, vw, x[which], per_head)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    fail(f"B2 {mode} output not finite at b={b}, {which} bias")
                err = (got - want).abs().max().item()
                tol = GRAPH_RTOL * want.abs().max().item()
                # degenerate rows, against what they must be
                uniform = vw[0].mean(0)
                checks = {"empty_row": (got[0, 3] - uniform).abs().max().item()}
                if b > 1:
                    checks["padded"] = (got[-1] - vw[-1].mean(0)).abs().max().item()
                if per_head:
                    under = (got[0, 9, 1:] - uniform[1:]).abs().max().item() if which == "per_head" else 0.0
                else:
                    under = max(got[0, 7, 1:].abs().max().item(),
                                got[0, 9, 1:].abs().max().item() if which == "per_head" else 0.0)
                row[f"{mode}_{which}_err"] = err
                row[f"{mode}_{which}_underflow"] = under
                row[f"{mode}_{which}_degenerate"] = checks
                if not err <= tol:
                    fail(f"B2 {mode} vs plain max abs diff {err} > {tol} at b={b}, {which} bias")
                if any(not v <= tol for v in checks.values()):
                    fail(f"B2 {mode}: degenerate rows {checks} not uniform at b={b}, {which} bias")
                if per_head and not under <= tol:
                    fail(f"B2 v1: heads without edges not uniform ({under}) at b={b}")
                if not per_head and under != 0.0:
                    fail(f"B2 v2: underflowing heads are not zero ({under}) at b={b}, {which} bias")
        # the library yardstick: one SDPA call, float mask, head-major layout
        qs, ks, vs = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, vw))
        mask = x["shared"].permute(0, 2, 1, 3)  # [b, 1, R, n], broadcast over heads
        sdpa = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask).permute(0, 2, 1, 3)
        row["sdpa_vs_v1_plain"] = (
            sdpa - ga.graph_attention_plain(q, k, vw, x["shared"], True)).abs().max().item()
        fns = {
            "ms": lambda: ga.fused_graph_attention(q, k, vw, x["shared"]),
            "plain_ms": lambda: ga.graph_attention_plain(q, k, vw, x["shared"]),
            "v1_ms": lambda: ga.fused_graph_attention(q, k, vw, x["shared"], True),
            "v1_plain_ms": lambda: ga.graph_attention_plain(q, k, vw, x["shared"], True),
            "sdpa_ms": lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
            "per_head_bias_ms": lambda: ga.fused_graph_attention(q, k, vw, x["per_head"]),
        }
        if baseline is not None:
            base = baseline.fused_graph_attention(q, k, vw, x["shared"])
            row["baseline_vs_plain"] = (base - ga.graph_attention_plain(
                q, k, vw, x["shared"])).abs().max().item()
            fns["baseline_ms"] = lambda: baseline.fused_graph_attention(q, k, vw, x["shared"])
        row.update(zip(fns, median_ms_interleaved(list(fns.values()))))
        out_bytes = nbytes(q) // q.shape[3] * vw.shape[3]
        row.update(bound(nbytes(q, k, vw, x["shared"]) + out_bytes, graph_flops(b)))
        row["per_head_bias_bound_ms"] = bound(
            nbytes(q, k, vw, x["per_head"]) + out_bytes, graph_flops(b))["bound_ms"]
        print("kernel graph_attention", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def check_graph_grads(device):
    """dq, dk, dvw, dbias through `GraphAttention` (the kernel forward and
    the backward kernel) vs torch autograd of the plain version at b = 32
    and 256, in both softmax modes (v2, v1) with the shared and the per-head
    bias of graph_inputs (its rows with every key masked, and with heads
    that underflow); one backward launch per Function call. Returns the
    rows."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga

    rows = []
    for b in (32, 256):
        x = graph_inputs(b, device, seed=300 + b)
        G = torch.randn(x["q"].shape, generator=torch.Generator(device=device).manual_seed(b),
                        device=device)
        for per_head in (False, True):
            for which in ("shared", "per_head"):
                names = ("q", "k", "vw", which)
                where = f"b={b}, {'v1' if per_head else 'v2'}, {which} bias"

                def fwd_bwd(fn):
                    leaves = [x[n].clone().requires_grad_() for n in names]
                    out = fn(*leaves, per_head)
                    return out.detach(), torch.autograd.grad((out * G).sum(), leaves)

                before = backward_launches("b2")
                out_k, grads_k = fwd_bwd(ga.fused_graph_attention)
                launched = backward_launches("b2") - before
                out_p, grads_p = fwd_bwd(ga.graph_attention_plain)
                with torch.no_grad():
                    direct = ga.KERNEL(*(x[n] for n in names), per_head)
                torch.cuda.synchronize()
                row = {"b": b, "v1": per_head, "bias": which, "backward_launches": launched,
                       "function_out": (out_k - direct).abs().max().item()}
                for n, gk, gp in zip(("dq", "dk", "dvw", "dbias"), grads_k, grads_p):
                    if not torch.isfinite(gk).all():
                        fail(f"B2 gradient {n} not finite at {where}")
                    row[n] = max_rel(gk, gp)
                if not per_head and which == "shared":
                    row["fwd_bwd_ms"], row["fwd_bwd_plain_ms"] = median_ms_interleaved(
                        [lambda: fwd_bwd(ga.fused_graph_attention),
                         lambda: fwd_bwd(ga.graph_attention_plain)], reps=21, calls=3)
                print("kernel graph_attention gradients", json.dumps(row), flush=True)
                if row["function_out"] != 0.0:
                    fail(f"B2 Function forward differs from the launch at {where}")
                if launched != 1:
                    fail(f"B2 Function: {launched} backward launches for one call at {where}")
                for n in ("dq", "dk", "dvw", "dbias"):
                    if not row[n] <= GRAPH_GRAD_RTOL:
                        fail(f"B2 gradient {n} differs by rel {row[n]} > {GRAPH_GRAD_RTOL} at "
                             f"{where}")
                rows.append(row)
    return rows


def graph_bwd_flops(b, R=SERVE_SHAPES["R"], H=SERVE_SHAPES["H"], n=SERVE_SHAPES["n"],
                    dh=SERVE_SHAPES["dh"], o=SERVE_SHAPES["o"]):
    """f32 operations of one B2 backward: per (row, head, key) the q.k and
    g.vw dots rebuilt, the dq, dk and dvw sums."""
    return 2.0 * b * R * H * n * (3 * dh + 2 * o)


# phase 27's cases: (b, R, H, v1, bias, widths other than the model's); those
# with other widths, or 12 heads, run the general instance
GRAPH_BACKWARD_CASES = (
    (256, 100, 16, False, "shared", {}),  # the model's: timed, its memory held
    (256, 64, 16, False, "shared", {}),  # the roi buckets: timed
    (256, 36, 16, False, "shared", {}),
    (256, 100, 16, False, "per_head", {}),
    (256, 100, 16, True, "shared", {}),
    (256, 100, 16, True, "per_head", {}),
    (32, 100, 16, False, "shared", {}),  # row chunks: the reduce adds dK and dVW
    (8, 100, 16, False, "shared", {}),
    (256, 100, 8, False, "shared", {}),  # one head group: no dbias sum to add
    (64, 100, 12, False, "shared", {}),  # 12 heads: 4 a block, the general instance, timed
    (64, 100, 8, False, "shared", dict(dh=128, o=128)),  # relation_dim 1024 over 8 heads
    (64, 36, 16, False, "per_head", dict(n=10)),  # --nongt_dim 10
    (64, 36, 16, True, "shared", dict(n=7)),  # keys not a multiple of 4
    (64, 100, 16, False, "shared", dict(o=32)),  # a value width other than the head's
)


def check_graph_backward(device):
    """Phase 27: B2's backward kernel against graph_attention_backward, the
    transcription the CPU runs, on the same inputs (GRAPH_BACKWARD_CASES):
    dq, dk, dvw and dbias within GRAPH_GRAD_RTOL, two launches giving equal
    bits, the forward's row maxima against the plain version's affinities;
    the device memory one backward allocates at the model's shapes (no
    [b, R, H, n] tensor); the kernel's time against the transcription's and
    its bound at R = 100, 64 and 36 (b=256) and for the general instance's
    first case; forward plus backward against autograd of the plain version
    at the model's shapes. Returns the rows."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga

    names = ("dq", "dk", "dvw", "dbias")
    rows, general_timed = [], False
    for i, (b, R, H, per_head, which, widths) in enumerate(GRAPH_BACKWARD_CASES):
        s = {**SERVE_SHAPES, **widths}
        n, dh, o = s["n"], s["dh"], s["o"]
        x = graph_inputs(b, device, seed=500 + i, R=R, H=H, widths=widths)
        q, k, vw, bias = x["q"], x["k"], x["vw"], x[which]
        G = torch.randn(b, R, H, o, generator=torch.Generator(device=device).manual_seed(600 + i),
                        device=device)
        with torch.no_grad():
            _, rowmax = ga.KERNEL(q, k, vw, bias, per_head, save_max=True)

        def kernel():
            return ga.KERNEL.backward(G, q, k, vw, bias, rowmax, per_head)

        def transcription():
            return ga.graph_attention_backward(G, q, k, vw, bias, per_head)

        plan = ga.backward_plan(b, R, n, H, dh, o)
        general = (plan.heads, n, dh, o) not in ga.BWD_SPECIALISED
        got, again, want = kernel(), kernel(), transcription()
        torch.cuda.synchronize()
        where = f"b={b}, R={R}, H={H}, {'v1' if per_head else 'v2'}, {which} bias, {widths}"
        for name, t in zip(names, got):
            if not torch.isfinite(t).all():
                fail(f"B2 backward: {name} not finite at {where}")
        errs = {m: max_rel(a, w) for m, a, w in zip(names[:3], got, want)}
        errs["dbias"] = max_rel(got[3].sum_to_size(bias.shape), want[3].sum_to_size(bias.shape))
        row = dict(b=b, R=R, H=H, v1=per_head, bias=which, widths=widths, general=general,
                   plan=plan._asdict(), **errs,
                   equal_bits_twice=all(torch.equal(a, c) for a, c in zip(got, again)))
        if not per_head:
            # the row max the backward rebuilds the weights against, vs the
            # plain version's affinities (in the rows with an edge: others
            # sit at the -9e15 masks)
            aff = (torch.einsum("brhd,bnhd->brhn", q, k) / math.sqrt(dh) + bias).amax(dim=(2, 3))
            live = aff > -1e15
            row["rowmax"] = (rowmax - aff)[live].abs().max().item()
            del aff
        del got, again, want
        if i == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            res = kernel()
            torch.cuda.synchronize()
            row["bwd_peak_bytes"] = torch.cuda.max_memory_allocated(device) - base
            workspace = (H // plan.heads) * b * R * n * 4 if H > plan.heads else 0
            row["bwd_outputs_bytes"] = nbytes(*res) + workspace
            row["weights_bytes"] = b * R * H * n * 4  # one [b, R, H, n] f32
            del res

            def fwd_bwd(fn):
                leaves = [t.clone().requires_grad_() for t in (q, k, vw, bias)]
                out = fn(*leaves, per_head)
                return torch.autograd.grad((out * G).sum(), leaves)

            row["fwd_bwd_ms"], row["fwd_bwd_plain_ms"] = median_ms_interleaved(
                [lambda: fwd_bwd(ga.fused_graph_attention),
                 lambda: fwd_bwd(ga.graph_attention_plain)], reps=21, calls=3)
        if i in (0, 1, 2) or general and not general_timed:
            general_timed |= general
            row["bwd_ms"], row["bwd_transcription_ms"] = median_ms_interleaved(
                [kernel, transcription], reps=21, calls=3)
            # read: g, q, k, vw, the bias, the row maxima; written: dq, dk,
            # dvw and dbias in the bias's own layout
            moved = nbytes(G, q, k, vw, bias, rowmax, q, k, vw, bias)
            row.update(bound(moved, graph_bwd_flops(b, R, H, n, dh, o)))
        print("kernel graph_attention backward", json.dumps(row), flush=True)
        if not row["equal_bits_twice"]:
            fail(f"B2 backward: two launches on the same inputs differ at {where}")
        limits = [(m, GRAPH_GRAD_RTOL) for m in names] + (
            [] if per_head else [("rowmax", KERNEL_ATOL)])
        for name, tol in limits:
            if not row[name] <= tol:
                fail(f"B2 backward: {name} differs by {row[name]} > {tol} at {where}")
        if i == 0 and row["bwd_peak_bytes"] > row["bwd_outputs_bytes"] + 2**20:
            fail(f"B2 backward allocated {row['bwd_peak_bytes']} B for "
                 f"{row['bwd_outputs_bytes']} B of outputs and workspace")
        rows.append(row)
    return rows


def full_width_config(family, extra=(), config=None):
    from tf_vqa_regat_tpu_torch.config import parse_with_config

    return parse_with_config(
        ["--config", os.path.join(REPO, "configs", config or CONFIGS[family]), "--synthetic",
         *extra]
    )


def _sector_distance(sn: float, cs: float, lower: bool) -> float:
    """Distance (rad, float64) from the nearest multiple of pi/4 of the
    labelling angle for a pair with sine `sn` and cosine `cs`, by its own
    formulas (quadrants; the lower triangle's reverse-edge formula)."""
    if sn >= 0 and cs >= 0:
        angle = math.asin(sn)
    elif sn < 0 and cs >= 0:
        angle = math.asin(sn) + 2 * math.pi
    elif sn >= 0:
        angle = math.acos(cs)
    else:
        angle = -math.acos(max(-1.0, min(1.0, sn))) + 2 * math.pi
    if lower:
        angle = 2 * math.pi - angle if sn >= 0 else angle - math.pi
    step = math.pi / 4
    return abs(angle / step - round(angle / step)) * step


def sector_distances(bb, e, i, j):
    """(from build_spatial_graph's own f32 sine and cosine, from the boxes in
    float64): distances of the angle that labels pair (i, j) of example e
    from a sector boundary. The first is what one ulp of asin/acos can flip:
    both devices get the same f32 sine and cosine (their divisions and
    square roots round alike), and near +-pi/2 one ulp of the sine moves the
    angle by up to ~3.5e-4 rad, so the second may be much larger."""
    import torch

    a, c = (i, j) if i < j else (j, i)
    out = []
    for dtype in (torch.float32, torch.float64):
        box = bb[e].to(dtype)
        cx, cy = 0.5 * (box[:, 0] + box[:, 2]), 0.5 * (box[:, 1] + box[:, 3])
        y, x = cy[a] - cy[c], cx[a] - cx[c]
        d = torch.clamp(torch.sqrt(y**2 + x**2), min=1e-12)
        out.append(_sector_distance((y / d).item(), (x / d).item(), i > j))
    return tuple(out)


def check_spatial_labels(batch):
    """build_spatial_graph on the card vs on the CPU over one batch: every
    mismatch must be a sector label within SECTOR_EPS of a boundary."""
    from tf_vqa_regat_tpu_torch.ops.spatial_graph import build_spatial_graph

    gpu = build_spatial_graph(batch["bb"], batch["norm_bb"]).cpu()
    bb_cpu = batch["bb"].cpu()
    cpu = build_spatial_graph(bb_cpu, batch["norm_bb"].cpu())
    bad = (gpu != cpu).nonzero().tolist()
    dist = []
    for e, i, j in bad:
        sector = all(4 <= int(t[e, i, j]) <= 11 for t in (gpu, cpu))
        dist.append(sector_distances(bb_cpu, e, i, j) if sector else (math.inf, math.inf))
    print(f"spatial labels, card vs CPU over {gpu.numel()} pairs: {len(bad)} differ "
          f"(distances to a sector boundary, from the function's f32 sine/cosine "
          f"and from the boxes: {dist} rad); label counts "
          f"{gpu.flatten().bincount(minlength=13).tolist()}", flush=True)
    if any(not d <= SECTOR_EPS for d, _ in dist):
        fail(f"spatial labels differ away from a sector boundary: {bad} {dist}")
    return len(bad)


def check_train_step(device, family, extra=()):
    """One train step at the full widths of the family's config (with the
    flags `extra`), b=256: kernel path vs plain path, then the step's
    forward / backward / optimizer split. Returns the split (median ms) and
    the peak device memory (GB)."""
    import torch

    from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
    from tf_vqa_regat_tpu_torch.main import build_dataset
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
    from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
    from tf_vqa_regat_tpu_torch.train.step import train_forward

    cfg = full_width_config(family, ["--mode", "train", *extra])
    label = " ".join([family, *extra])
    ds = build_dataset(cfg, "train")
    store = DeviceStore(ds, device)
    idx = next(store.epoch_indices(0, cfg.batch_size, True, cfg.seed))
    batch = gather_batch(store, torch.from_numpy(idx).to(device), cfg.resolved_num_rois())
    if family == "spatial":
        check_spatial_labels(batch)
    model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device)
    params = list(model.parameters())

    def loss_and_grads():
        loss, _ = train_forward(model, batch, 0, cfg.seed)
        return loss.detach(), torch.autograd.grad(loss, params)

    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    with mutan_branches() as branches:
        loss_k, grads_k = loss_and_grads()
    launches = counts()
    b2_backward = backward_launches("b2")
    if family == "mutan":
        # the attention block's formulation, then the answer block's (2-D: naive)
        want = ["reassociated" if cfg.mutan_shared_qdrop else "naive", "naive"]
        if branches != want:
            fail(f"{label} train step ran the MuTAN formulations {branches}, expected {want}")
    with plain_kernels():
        loss_p, grads_p = loss_and_grads()
    torch.cuda.synchronize()
    trainable = trainable_mask(model, False)
    errs = leaf_gaps(model, zero_grad_leaves(model, cfg), grads_k, grads_p)
    worst, *runners_up = sorted(errs, key=errs.get, reverse=True)[:3]
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    print(f"{label} train step b={cfg.batch_size} kernel vs plain: loss {loss_k.item()} vs "
          f"{loss_p.item()} (rel {loss_err}), worst leaf {worst} rel {errs[worst]} (then "
          f"{', '.join(f'{n} {errs[n]}' for n in runners_up)}), "
          f"launches per forward {json.dumps(launches)}, B2 backward launches {b2_backward}, "
          f"MuTAN formulations {branches}", flush=True)
    if not all(torch.isfinite(g).all() for g in grads_k):
        fail(f"{label} train step: a gradient is not finite")
    kernel = "B1 train" if family in B1_FAMILIES else "B2"
    if launches[kernel] != 2 or sum(launches.values()) != 2:
        fail(f"{label} train step: launches per forward {launches}, expected 2 of {kernel}")
    if b2_backward != launches["B2"]:
        fail(f"{label} train step: {b2_backward} B2 backward launches for {launches['B2']} "
             "forward launches under grad")
    if not loss_err <= LOSS_RTOL:
        fail(f"{label} train step: loss differs by rel {loss_err} > {LOSS_RTOL}")
    if not errs[worst] <= STEP_GRAD_RTOL:
        fail(f"{label} train step: {worst} gradient differs by rel {errs[worst]} > "
             f"{STEP_GRAD_RTOL}")
    del grads_k, grads_p

    opt = Adamax(model, trainable, make_lr_schedule(
        cfg.base_lr, 16, cfg.lr_decay_rate, cfg.lr_decay_step), cfg.grad_clip)
    split = {"forward": [], "backward": [], "optimizer": []}
    for step in range(12):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = train_forward(model, batch, step, cfg.seed)
        ev[1].record()
        grads = torch.autograd.grad(loss, params)
        ev[2].record()
        opt.step(grads)
        ev[3].record()
        ev[3].synchronize()
        if step >= 2:  # warm-up
            for i, k in enumerate(split):
                split[k].append(ev[i].elapsed_time(ev[i + 1]))
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    return {k: statistics.median(v) for k, v in split.items()}, peak_gb


def check_mutan_branches(device):
    """MuTAN at full width on one eval batch (b=64 of the val split): the
    whole model with the attention block's reassociated formulation (what
    eval runs) against the naive one, and each forward's time. Returns the
    row printed."""
    import torch

    from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
    from tf_vqa_regat_tpu_torch.main import build_dataset
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT

    cfg = full_width_config("mutan", ["--mode", "eval"])
    ds = build_dataset(cfg)
    store = DeviceStore(ds, device)
    b = cfg.resolved_eval_batch()
    idx = next(store.epoch_indices(0, b, False, cfg.seed))
    batch = gather_batch(store, torch.from_numpy(idx).to(device), cfg.resolved_num_rois())
    model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device).eval()

    def forward(force_naive):
        with torch.no_grad(), mutan_branches(force_naive) as taken:
            return model(batch), taken

    (reassociated, branches), (naive, _) = forward(False), forward(True)
    torch.cuda.synchronize()
    if not (torch.isfinite(reassociated).all() and torch.isfinite(naive).all()):
        fail("MuTAN branch check: logits not finite")
    rel = max_rel(reassociated, naive)
    same_argmax = bool((reassociated.argmax(-1) == naive.argmax(-1)).all())
    ms, naive_ms = median_ms_interleaved(
        [lambda: forward(False), lambda: forward(True)], reps=11, calls=3)
    row = dict(b=b, branches=branches, rel=rel, argmax_equal=same_argmax,
               reassociated_forward_ms=ms, naive_forward_ms=naive_ms)
    print("mutan formulations, eval forward", json.dumps(row), flush=True)
    if branches != ["reassociated", "naive"]:
        fail(f"MuTAN eval ran the formulations {branches}")
    if not rel <= MUTAN_BRANCH_RTOL or not same_argmax:
        fail(f"MuTAN formulations disagree: rel {rel} > {MUTAN_BRANCH_RTOL} or argmax differs")
    return row


def expected_launches(family, passes, train_passes=0):
    """Launch counts of a path with `passes` eval forward passes and
    `train_passes` train forward passes: 2 per pass, of the family's kernel."""
    want = {"B1 eval": 0, "B1 train": 0, "B2": 0, "B2 per-head": 0}
    if family in B1_FAMILIES:
        want["B1 eval"], want["B1 train"] = 2 * passes, 2 * train_passes
    else:
        want["B2"] = 2 * (passes + train_passes)
    return want


@contextlib.contextmanager
def timed_steps():
    """Record every train step the entry point takes, as (R, CUDA events
    before and after it, its loss, whether its batch carries edge labels,
    whether the call captured its graph first): a spy on TrainSteps.step,
    through which each step's graph replays. The loss is copied, since the
    next replay overwrites the graph's output."""
    import torch

    from tf_vqa_regat_tpu_torch.train.step import TrainSteps

    real, records = TrainSteps.step, []

    def step(self, R, inputs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        graphs = len(self.graphs.capture_seconds())
        ev[0].record()
        m = real(self, R, inputs)
        ev[1].record()
        adj = ("adj_label" in inputs if self.store is None
               else self.store.images.adj is not None)
        records.append((R, ev, m["loss"].clone(), adj,
                        len(self.graphs.capture_seconds()) > graphs))
        return m

    TrainSteps.step = step
    try:
        yield records
    finally:
        TrainSteps.step = real


def check_entry_point(tmp, smi, family, extra=(), config=None, data=None, falling=True):
    """`--mode train` then `--mode eval` through `main.main`, at the widths
    of the family's config (or `config`), on the synthetic data or the
    dataset in `data`: finite losses, falling (with `falling`) from the
    first step to the last, the eval loss equal to the run's last, 2
    launches per forward pass. Returns (npz path, launches of the train run,
    median step ms); LAST_TRAIN holds the run's split sizes and how many
    train batches carried edge labels."""
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main

    argv = entry_argv(family, tmp, "--print_freq", "4", *extra, config=config, data=data)
    label = " ".join([config or family, *extra] + (["(real layout)"] if data else []))
    real_run, sizes = port_main.run_training, {}

    def sized_run(cfg, train_ds, val_ds, *args, **kw):
        sizes.update(train=len(train_ds), val=len(val_ds), train_name=train_ds.name,
                     val_name=val_ds.name)
        return real_run(cfg, train_ds, val_ds, *args, **kw)

    port_main.run_training = sized_run
    reset_counts()  # the train path starts here
    t0 = time.perf_counter()
    try:
        with timed_steps() as records:
            path = port_main.main(argv + ["--mode", "train", "--epochs", "1"])
    finally:
        port_main.run_training = real_run
    wall = time.perf_counter() - t0
    cfg = port_main.parse(argv + ["--mode", "train"])[0]
    launches = read_path_counts(cfg)
    torch.cuda.synchronize()
    # the steps that replayed a graph captured before them
    step_ms = [ev[0].elapsed_time(ev[1]) for _, ev, _, _, cap in records if not cap]
    # start to start on the device's timeline: the step plus any wait for
    # its batch (the host data path's stalls fall between steps)
    periods = [a[0].elapsed_time(b[0]) for (_, a, *_), (_, b, *_, cap)
               in zip(records, records[1:]) if not cap]
    losses = [float(loss) for _, _, loss, _, _ in records]
    LAST_TRAIN.clear()
    LAST_TRAIN.update(sizes, steps=len(records), adj_batches=sum(r[3] for r in records),
                      period_ms=statistics.median(periods) if periods else None)
    with open(os.path.join(tmp, "metrics.jsonl")) as fh:
        last = [json.loads(line) for line in fh][-1]
    print(f"{label} --mode train: {len(losses)} steps in {wall:.1f} s (run, set-up "
          f"included); median step {statistics.median(step_ms)} ms (CUDA events, the "
          f"steps after the first, which captures) on {smi}, "
          f"TF32 off; losses {losses}; launches {json.dumps(launches)}; splits "
          f"{json.dumps(LAST_TRAIN)}; last metrics {json.dumps(last)}; dropout launches "
          f"{json.dumps(PATH_DROPOUT[-1])}", flush=True)
    if len(losses) != -(-sizes["train"] // cfg.batch_size):
        fail(f"{label} --mode train took {len(losses)} steps for {sizes['train']} questions")
    if not all(map(math.isfinite, losses)) or (falling and not losses[-1] < losses[0]):
        fail(f"{label} --mode train: loss not finite or not falling: {losses}")
    eval_passes = -(-sizes["val"] // cfg.resolved_eval_batch())
    if launches != expected_launches(family, eval_passes, len(losses)):
        fail(f"{label} --mode train: launches {launches} for {len(losses)} train and "
             f"{eval_passes} eval forward passes")
    if PATH_BACKWARD[-1] != launches["B1 train"]:
        fail(f"{label} --mode train: {PATH_BACKWARD[-1]} B1 backward launches for "
             f"{launches['B1 train']} train launches")
    # B2's forward launches under grad: 2 per train step where B2 carries
    # the family
    b2_train = 0 if family in B1_FAMILIES else 2 * len(losses)
    if PATH_B2_BACKWARD[-1] != b2_train:
        fail(f"{label} --mode train: {PATH_B2_BACKWARD[-1]} B2 backward launches for "
             f"{b2_train} train-forward launches")

    reset_counts()  # the eval path starts here
    score, loss = port_main.main(argv + ["--mode", "eval", "--checkpoint", path])
    eval_launches = counts()
    if any(dropout_launches().values()):
        fail(f"{label} --mode eval launched dropout: {dropout_launches()}")
    rel = abs(loss - last["eval_loss"]) / abs(last["eval_loss"])
    print(f"{label} --mode eval on {os.path.basename(path)}: score {score} loss {loss} vs "
          f"the training run's {last['eval_loss']} (rel {rel}); launches "
          f"{json.dumps(eval_launches)}", flush=True)
    if not rel <= EVAL_LOSS_RTOL:
        fail(f"{label} --mode eval loss differs from the training run's by rel {rel}")
    if eval_launches != expected_launches(family, eval_passes):
        fail(f"{label} --mode eval: launches {eval_launches} for {eval_passes} passes")
    return path, launches, statistics.median(step_ms)


def http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def check_serve(ckpt, family, extra=(), config=None, data=None, bf16=False):
    """--mode serve of `ckpt` at the widths of the family's config (or
    `config`), with the flags `extra`, on the synthetic val split or the
    dataset in `data`. Under `bf16` (--compute_dtype bfloat16 in `extra`)
    the served logits are held to the plain path's within
    BF16_PATH_LOGITS_RTOL, and an answer may differ only where the plain
    path's top two lie within twice the largest difference (a counted tie).
    Returns (launches, forward passes, logits max abs diff)."""
    import torch

    from tf_vqa_regat_tpu_torch.config import parse_with_config
    from tf_vqa_regat_tpu_torch.main import build_datasets, build_server

    argv = ["--config", os.path.join(REPO, "configs", config or CONFIGS[family]), "--mode",
            "serve", *data_flags(data), "--serve_port", "0", *extra]
    cfg = parse_with_config(argv)
    ds = build_datasets(cfg)[1]
    label = " ".join([config or family, *extra])
    t0 = time.perf_counter()
    server, batcher, engine = build_server(argv + ["--checkpoint", ckpt, "--device", "cuda"])
    print(f"{label} server built and warmed in {time.perf_counter() - t0:.1f} s "
          f"(batch sizes {list(engine.batch_sizes)})", flush=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    # each engine call is one forward pass, a replay of its size's graph
    # (a forward hook would run at the capture only)
    forwards, real_step = [0], engine.step

    def counted_step(*args):
        forwards[0] += 1
        return real_step(*args)

    engine.step = counted_step
    try:
        ids = sorted(engine.img_index)[:12]
        questions = ["what color is the car ?", "how many people are on the left ?",
                     "is the man on the dog ?", "what is the woman in ?"]
        reset_counts()  # the serve path starts here
        code, health = http(url + "/healthz")
        if code != 200 or health.get("status") != "ok":
            fail(f"/healthz: {code} {health}")
        answers = []
        for i, q in enumerate(questions):
            code, body = http(url + "/predict", {"question": q, "image_id": ids[i]})
            if code != 200:
                fail(f"/predict single: {code} {body}")
            answers.append(body)
        code, body = http(url + "/predict", [
            {"question": questions[i % 4], "image_id": ids[i]} for i in range(8)])
        if code != 200 or len(body) != 8:
            fail(f"/predict batch: {code} {body}")
        answers += body
        code, missing = http(url + "/predict", {"question": "what ?", "image_id": 10**9})
        launches, passes = read_path_counts(), forwards[0]
        print(f"/healthz {json.dumps(health)}", flush=True)
        print(f"/predict answers {json.dumps(answers)}", flush=True)
        print(f"/predict unknown image: {code} {json.dumps(missing)}", flush=True)
        if code != 404:
            fail(f"unknown image_id gave {code}, expected 404")
        for a in answers:
            if a.get("answer") not in ds.label2ans or not 0.0 < a["confidence"] < 1.0:
                fail(f"bad answer {a}")
        print(f"{label} kernel launches {json.dumps(launches)} over {passes} forward "
              f"passes", flush=True)
        if passes == 0 or launches != expected_launches(family, passes):
            fail(f"expected 2 launches per forward pass, got {launches} for {passes}")

        # One batch of 8 through the whole model: kernel path vs plain path.
        dev = engine.device
        toks = torch.tensor([engine._encode(questions[i % 4]) for i in range(8)], device=dev)
        img = torch.tensor([engine.img_index[i] for i in ids[:8]], device=dev)
        valid = torch.ones(8, dtype=torch.bool, device=dev)
        got = engine.logits(toks, img, valid)
        with plain_kernels():
            want = engine.logits(toks, img, valid)
        torch.cuda.synchronize()
        if got.shape != (8, ds.num_ans) or not torch.isfinite(got).all():
            fail(f"logits {tuple(got.shape)} not finite or not [8, {ds.num_ans}]")
        logits_err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        rtol = BF16_PATH_LOGITS_RTOL if bf16 else LOGITS_RTOL
        flips = got.argmax(-1) != want.argmax(-1)
        top2 = want.topk(2, dim=-1).values
        ties = (top2[:, 0] - top2[:, 1]) <= 2 * logits_err
        same_argmax = not bool((flips & ~ties).any() if bf16 else flips.any())
        print(f"{label} logits kernel vs plain: max abs diff {logits_err}, largest |logit| "
              f"{scale} (tol {rtol} of it), argmax equal {same_argmax} ({int(flips.sum())} "
              f"differ, {int(ties.sum())} ties within {2 * logits_err})", flush=True)
        if not logits_err <= rtol * scale or not same_argmax:
            fail("served logits disagree with the plain path")

        # Host-clock latency of one engine call per fixed batch size.
        latency = {}
        for B in engine.batch_sizes:
            qs = [questions[i % 4] for i in range(B)]
            im = [ids[i % len(ids)] for i in range(B)]
            runs = []
            for _ in range(23):
                t0 = time.perf_counter()
                engine.infer(qs, im)
                runs.append((time.perf_counter() - t0) * 1e3)
            latency[B] = statistics.median(runs[3:])
        print(f"{label} engine.infer median ms by batch size {json.dumps(latency)}",
              flush=True)
    finally:
        engine.step = real_step
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=10)
    return launches, passes, logits_err


def data_flags(data=None):
    """The synthetic data, or the dataset under the folder `data`."""
    return ["--synthetic"] if data is None else ["--data_folder", data]


def entry_argv(family, tmp, *extra, config=None, data=None):
    """`main.main`'s arguments for the family's config on the card."""
    return ["--config", os.path.join(REPO, "configs", config or CONFIGS[family]),
            *data_flags(data), "--output", tmp, "--device", "cuda", *extra]


@contextlib.contextmanager
def recorded_saves():
    """Each checkpoint save the training loop makes: (kind, seconds the call
    took, seconds it waited for the previous write)."""
    from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt

    real, saves = ckpt.save_checkpoint, []

    def spy(*args, **kw):
        t0 = time.perf_counter()
        waited = real(*args, **kw)
        saves.append(("step" if kw.get("step_in_epoch") is not None else "epoch",
                      time.perf_counter() - t0, waited))
        return waited

    ckpt.save_checkpoint = spy
    try:
        yield saves
    finally:
        ckpt.save_checkpoint = real


def read_run(out, name="implicit-butd"):
    """(final parameters, per-epoch metrics) of a --mode train output."""
    import numpy as np

    with np.load(os.path.join(out, f"{name}-pretrained_model.npz")) as z:
        params = {k: z[k] for k in z.files}
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        metrics = {m["epoch"]: m for m in map(json.loads, fh)}
    return params, metrics


def run_distance(a, b):
    """(largest |a - b| over the parameters, largest excess over
    RESUME_ATOL + RESUME_RTOL |a|, largest relative metric difference,
    bit-equal) between two runs read by read_run."""
    import numpy as np

    (pa, ma), (pb, mb) = a, b
    if sorted(pa) != sorted(pb) or sorted(ma) != sorted(mb):
        fail(f"runs differ in their keys or epochs: {sorted(ma)} vs {sorted(mb)}")
    diff = max(float(np.abs(pa[k] - pb[k]).max()) for k in pa)
    excess = max(float((np.abs(pa[k] - pb[k]) - RESUME_ATOL - RESUME_RTOL * np.abs(pa[k])).max())
                 for k in pa)
    metric = max(abs(ma[e][k] - mb[e][k]) / max(abs(ma[e][k]), 1e-30)
                 for e in ma for k in ("train_loss", "train_score", "eval_score", "eval_loss"))
    bits = all(np.array_equal(pa[k], pb[k]) for k in pa) and all(
        ma[e][k] == mb[e][k] for e in ma
        for k in ("train_loss", "train_score", "eval_score", "eval_loss"))
    return diff, excess, metric, bits


def preempted_then_resumed(out, flags):
    """configs/butd_vqa.json's `--mode train` with `flags` in `out`: (b) under
    REGAT_FAULT_PREEMPT_STEP=8, which must return with meta at epoch 1,
    step 2 and no final .npz, then (c) the same with `--resume`. Returns
    (c)'s run (read_run), its launches and its saves."""
    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt

    os.environ["REGAT_FAULT_PREEMPT_STEP"] = "8"
    try:
        if port_main.main(entry_argv("implicit", out, *flags)) is not None:
            fail("the run with REGAT_FAULT_PREEMPT_STEP=8 was not preempted")
    finally:
        del os.environ["REGAT_FAULT_PREEMPT_STEP"]
    meta = ckpt.restore_meta_full(out)
    print(f"resume run (b) {' '.join(flags)}, preempted: meta {json.dumps(meta)}", flush=True)
    if (meta or {}).get("epoch") != 1 or meta.get("step_in_epoch") != 2:
        fail(f"preempted run left meta {meta}, expected epoch 1, step_in_epoch 2")
    if any(f.endswith(".npz") for f in os.listdir(out)):
        fail("the preempted run wrote a final .npz")
    reset_counts()  # the resumed path starts here
    argv = entry_argv("implicit", out, *flags, "--resume")
    with recorded_saves() as saves:
        path = port_main.main(argv)
    launches = read_path_counts(port_main.parse(argv)[0])
    if path is None:
        fail("the resumed run was preempted")
    return read_run(out), launches, saves


def check_resume(tmp, smi, device):
    """Phase 11. Returns the launches of the resumed run (c)."""
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
    from tf_vqa_regat_tpu_torch.params import state_tensors
    from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt
    from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule

    flags = ["--mode", "train", "--epochs", "2", "--synthetic_train_size", "1536",
             "--checkpoint_every_steps", "2", "--train_block", "2"]
    outs = {k: os.path.join(tmp, k) for k in ("a", "a2", "b")}
    runs = {}
    for name in ("a", "a2"):
        with recorded_saves() as saves:
            t0 = time.perf_counter()
            path = port_main.main(entry_argv("implicit", outs[name], *flags))
            wall = time.perf_counter() - t0
        if path is None:
            fail(f"resume run ({name}) was preempted")
        runs[name] = read_run(outs[name])
        print(f"resume run ({name}): {wall:.1f} s; saves (kind, call s, waited s) "
              f"{json.dumps(saves)}, {sum(w for _, _, w in saves):.3f} s waited in all, "
              f"on {smi}", flush=True)
    resumed, launches, saves = preempted_then_resumed(outs["b"], flags)
    diff, excess, metric, bits = run_distance(runs["a"], resumed)
    s_diff, s_excess, s_metric, s_bits = run_distance(runs["a"], runs["a2"])
    print(f"resume (c) vs uninterrupted (a): params max abs diff {diff} (excess over "
          f"atol {RESUME_ATOL} + rtol {RESUME_RTOL}: {excess}), metrics max rel diff {metric}, "
          f"bit-equal {bits}; run-to-run spread (a2) vs (a): {s_diff} (excess {s_excess}), "
          f"metrics {s_metric}, bit-equal {s_bits}; launches of (c) {json.dumps(launches)}; "
          f"saves of (c) {json.dumps(saves)}", flush=True)
    if not excess <= 0.0 or not metric <= RESUME_RTOL:
        fail(f"the resumed run differs from the uninterrupted one: params excess {excess}, "
             f"metrics rel {metric}")
    cfg = full_width_config("implicit", ["--mode", "train"])
    passes = -(-cfg.synthetic_val_size // cfg.resolved_eval_batch())
    if launches != expected_launches("implicit", passes, 4):
        fail(f"resumed run: launches {launches} for 4 train steps and {passes} eval passes")
    for k in ("a", "a2", "b"):
        shutil.rmtree(os.path.join(outs[k], "checkpoints"))

    # why the port's word embedding picks its lookup per device: the
    # backward of each candidate, five times on the step's token shapes
    import torch.nn.functional as F

    from tf_vqa_regat_tpu_torch.ops.embedding import Embedding

    emb = Embedding(25, 300, torch.Generator().manual_seed(0)).to(device)
    ids = torch.randint(0, 25, (256, 14), device=device)
    g_out = torch.randn(256, 14, 300, device=device)
    lookups = {"Embedding (the port's)": lambda: emb(ids, 24),
               "F.embedding": lambda: F.embedding(ids, emb.table),
               "advanced indexing": lambda: emb.table[ids]}
    stable = {}
    for label, lookup in lookups.items():
        grads = [torch.autograd.grad((lookup() * g_out).sum(), emb.table)[0] for _ in range(5)]
        stable[label] = all(torch.equal(grads[0], x) for x in grads[1:])
    print(f"embedding backward gives equal bits over 5 calls: {json.dumps(stable)}", flush=True)
    if not stable["Embedding (the port's)"]:
        fail("the word embedding's backward is not deterministic on the card")

    # one blocking and one async save of the full-width state, timed alone
    model = ReGAT(cfg, 24, 2048, 3129).to(device)
    opt = Adamax(model, trainable_mask(model, False),
                 make_lr_schedule(cfg.base_lr, 6, 0.75, 2), cfg.grad_clip)
    state = state_tensors(model, opt)
    nbytes_state = sum(v.numel() * v.element_size() for v in state.values())
    out = os.path.join(tmp, "save")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save_checkpoint(out, state, 0, 0.0, False, block=True)
    blocking = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.save_checkpoint(out, state, 1, 0.0, False, block=False)
    returned = time.perf_counter() - t0
    ckpt.wait_pending()
    background = time.perf_counter() - t0
    print(f"full-width state ({nbytes_state / 1e6:.1f} MB: params, mu, nu, count) on {smi}: "
          f"blocking save {blocking:.3f} s; async save returned after {returned:.4f} s, "
          f"written after {background:.3f} s", flush=True)
    shutil.rmtree(out)
    return launches


def batch_passes(store, cfg, device):
    """The eval batches of the split in entry order (per bucket under
    --roi_buckets), gathered on the card."""
    import torch

    from tf_vqa_regat_tpu_torch.data.store import gather_batch
    from tf_vqa_regat_tpu_torch.train.loop import eval_batch_stream

    for R, idx in eval_batch_stream(cfg, store, cfg.resolved_eval_batch()):
        yield idx, gather_batch(store, torch.from_numpy(idx).to(device), R)


def check_predict(tmp, smi, family, npz, device, extra=(), config=None, data=None):
    """Phase 12 for one family (with the flags `extra`, under the family's
    config or `config`, on the synthetic data or the dataset in `data`).
    Returns the launches of the predict path."""
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.train import loop

    argv = entry_argv(family, tmp, "--mode", "predict", "--checkpoint", npz, *extra,
                      config=config, data=data)
    real, timed = loop.run_prediction, []
    label = " ".join([config or family, *extra])

    def timed_prediction(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        return out

    loop.run_prediction = timed_prediction
    port_main.run_prediction = timed_prediction
    reset_counts()  # the predict path starts here
    try:
        path = port_main.main(argv)
    finally:
        loop.run_prediction = port_main.run_prediction = real
    launches = read_path_counts()
    with open(path) as fh:
        got = json.load(fh)
    cfg = port_main.parse(argv)[0]
    ds = port_main.build_datasets(cfg)[1]
    passes = -(-len(ds.entries.question_ids) // cfg.resolved_eval_batch())
    qids = [d["question_id"] for d in got]
    if sorted(qids) != sorted(ds.entries.question_ids.tolist()) or len(set(qids)) != len(qids):
        fail(f"{label} predictions: {len(qids)} entries, not each question id once")
    if launches != expected_launches(family, passes):
        fail(f"{label} --mode predict: launches {launches} for {passes} passes")

    model = port_main.load_model(cfg, ds).to(device).eval()
    store = loop.build_store(cfg, ds, device, targets=False)
    batches = list(batch_passes(store, cfg, device))
    kernel, plain = [], []
    with torch.no_grad():
        for idx, batch in batches:
            ok = torch.from_numpy(idx >= 0).to(device)
            kernel.append(model(batch)[ok])
            with plain_kernels():
                plain.append(model(batch)[ok])

        def forward_pass():
            for _, batch in batches:
                model(batch).argmax(dim=-1)

        pass_ms = median_ms_interleaved([forward_pass], reps=5, calls=1, warmup=1)[0]
    kernel, plain = torch.cat(kernel), torch.cat(plain)
    diff = (kernel - plain).abs().max().item()
    scale = plain.abs().max().item()
    top2 = plain.topk(2, dim=-1)
    # an answer can flip only where the top two lie within twice the
    # largest difference of the two paths' logits
    tie = ((top2.values[:, 0] - top2.values[:, 1]) <= 2 * diff).cpu()
    answers = [ds.label2ans[int(a)] for a in top2.indices[:, 0].cpu()]
    wrong = [i for i, d in enumerate(got) if not tie[i] and d["answer"] != answers[i]]
    print(f"{label} --mode predict: {len(got)} answers written in a pass of {timed[0]:.3f} s "
          f"({passes} batches of {cfg.resolved_eval_batch()}, host clock, store upload "
          f"included); the forward passes alone {pass_ms:.2f} ms (CUDA events, median of 5, "
          f"batches gathered) on {smi}; launches {json.dumps(launches)}; logits kernel vs plain max abs "
          f"diff {diff} of scale {scale}; {int(tie.sum())} ties within {2 * diff}; "
          f"{len(wrong)} other answers differ", flush=True)
    if not diff <= LOGITS_RTOL * scale:
        fail(f"{label} predict logits differ by {diff} > {LOGITS_RTOL} of {scale}")
    if wrong:
        fail(f"{label} predictions differ from the plain path's argmax at {wrong[:10]}")
    return launches


def check_ensemble(tmp, smi, npz, device):
    """Phase 13. Returns the launches of the member's training run and of
    the ensemble path."""
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.data.store import DeviceStore
    from tf_vqa_regat_tpu_torch.train.ensemble import (
        averaged_probs,
        load_members,
        member_adj_tables,
    )
    from tf_vqa_regat_tpu_torch.train.logging import Logger
    from tf_vqa_regat_tpu_torch.train.loss import vqa_score_sum

    out = os.path.join(tmp, "ensemble")
    reset_counts()  # the member's training path starts here
    argv = entry_argv("semantic", os.path.join(out, "implicit"), "--relation_type", "implicit",
                      "--mode", "train", "--epochs", "1", "--synthetic_train_size", "1536")
    member = port_main.main(argv)
    train_launches = read_path_counts(port_main.parse(argv)[0])
    print(f"ensemble implicit member trained under semantic_vqa.json: {member}; launches "
          f"{json.dumps(train_launches)}", flush=True)
    cfg = full_width_config("semantic", ["--mode", "train"])
    passes = -(-cfg.synthetic_val_size // cfg.resolved_eval_batch())
    if train_launches != expected_launches("implicit", passes, -(-1536 // cfg.batch_size)):
        fail(f"ensemble member training: launches {train_launches}")
    spec = f"implicit:{member},spatial:{npz['spatial']},semantic:{npz['semantic']}"
    argv = entry_argv("semantic", out, "--mode", "ensemble_eval", "--ensemble_checkpoints", spec)
    reset_counts()  # the ensemble path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score = port_main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_path_counts()
    cfg = port_main.parse(argv)[0]
    ds = port_main.build_dataset(cfg)
    passes = -(-len(ds.entries.question_ids) // cfg.resolved_eval_batch())
    want = {"B1 eval": 2 * passes, "B1 train": 0, "B2": 4 * passes, "B2 per-head": 0}
    if launches != want:
        fail(f"ensemble: launches {launches}, expected {want} for {passes} passes")

    members = load_members(cfg, ds, device, Logger(os.path.join(out, "compare_log.txt")))
    store = DeviceStore(ds, device)
    tables = member_adj_tables(members, ds, device)
    R = cfg.resolved_num_rois()
    diff, ties, moved, slack, n = 0.0, 0, 0, 0.0, 0.0
    score_k = score_p = torch.zeros((), device=device)
    for idx in store.epoch_indices(0, cfg.resolved_eval_batch(), False, cfg.seed):
        idx = torch.from_numpy(idx).to(device)
        got, batch = averaged_probs(members, store, idx, R, tables)
        with plain_kernels():
            want_p, _ = averaged_probs(members, store, idx, R, tables)
        valid = batch["valid"]
        diff = max(diff, (got - want_p)[valid].abs().max().item())
        top2 = want_p.topk(2, dim=-1)
        tied = ((top2.values[:, 0] - top2.values[:, 1]) <= ENSEMBLE_PROB_ATOL) & valid
        t = batch["target"].gather(1, top2.indices)
        moved += int(((got.argmax(-1) != top2.indices[:, 0]) & valid & ~tied).sum())
        ties += int(tied.sum())
        slack += float((t[:, 0] - t[:, 1]).abs()[tied].sum())
        # f32 sums on the card, in the order run_ensemble_eval takes
        score_k = score_k + vqa_score_sum(got, batch["target"], valid)
        score_p = score_p + vqa_score_sum(want_p, batch["target"], valid)
        n += float(valid.sum())
    score_k, score_p = 100.0 * float(score_k) / n, 100.0 * float(score_p) / n

    def ensemble_pass():
        for idx in store.epoch_indices(0, cfg.resolved_eval_batch(), False, cfg.seed):
            averaged_probs(members, store, torch.from_numpy(idx).to(device), R, tables)

    pass_ms = median_ms_interleaved([ensemble_pass], reps=5, calls=1, warmup=1)[0]
    print(f"ensemble {list(spec.split(','))}: score {score} (kernel path recomputed "
          f"{score_k}, plain path {score_p}); averaged probabilities kernel vs plain max abs "
          f"diff {diff}; {ties} ties within {ENSEMBLE_PROB_ATOL}, {moved} other answers differ; entry point {wall:.3f} s (host "
          f"clock, loads and store upload included, {passes} batches); the pass alone "
          f"{pass_ms:.2f} ms (CUDA events, median of 5, gathers included) on {smi}; launches "
          f"{json.dumps(launches)}", flush=True)
    if not diff <= ENSEMBLE_PROB_ATOL or moved:
        fail(f"ensemble probabilities differ by {diff} (tolerance {ENSEMBLE_PROB_ATOL}), "
             f"{moved} answers outside the ties differ")
    if abs(score - score_k) > 1e-6 * score or (
            abs(score_k - score_p) > 100.0 * slack / n + 1e-6 * score_p):
        fail(f"ensemble score {score} / {score_k} vs plain {score_p} (tie slack "
             f"{100.0 * slack / n})")
    LAST_ENSEMBLE.update(spec=spec, score=score, passes=passes)
    return train_launches, launches

ROWS = (36, 64)  # the roi buckets below 100 of the JAX bench's --roi_buckets 36,64,100
ROWS_BATCHES = (1, 32, 256)
BENCH_FLAGS = ("--feature_dtype", "bfloat16", "--compute_dtype", "bfloat16",
               "--roi_buckets", "36,64,100")
# the train split of the entry point's runs in 8 and 17: 6 steps of b=256
SHORT_TRAIN = ("--synthetic_train_size", "1536")
# phase 26's training run at widths other than the configuration's, which
# B1's backward runs through its general instance: 8 heads of 128, 12 keys,
# 32 embedding lanes
OTHER_WIDTHS = ("--nongt_dim", "12", "--imp_pos_emb_dim", "32", "--num_heads", "8")


def check_kernels_at_rows(device, R):
    """Phase 14 at R query rows (R = 36 and 64 leave a partial last 5-row
    tile): B1's eval variant and train variant (keep-mask at 51/256) and B2
    (v2, the shared and the per-head bias) against their plain versions at
    b = 1, 32, 256 under the bounds of 3-5, with their degenerate rows;
    times of each beside its plain version and bound, and SDPA beside B2.
    Returns per-b rows."""
    import torch
    import torch.nn.functional as F

    from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga
    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    s = SERVE_SHAPES
    rows = []
    for b in ROWS_BATCHES:
        x = kernel_inputs(b, device, seed=400 + R + b, R=R)
        args = [x[k] for k in KERNEL_ARGS]
        g = torch.Generator(device=device).manual_seed(600 + R + b)
        bits = torch.randint(0, 256, (b, R, s["n"], s["P"]), generator=g, device=device,
                             dtype=torch.uint8)
        targs = args + [0.2, (bits >= 51).view(torch.uint8)]
        y = graph_inputs(b, device, seed=500 + R + b, R=R)
        q, k, vw = y["q"], y["k"], y["vw"]
        with torch.no_grad():
            b1 = ia.fused_implicit_graph_attention(*args)
            b1_want = implicit_reference(*args)
            out_t, pwr_t, _ = ia.KERNEL(*targs, save_pwr=True)
            out_r, pwr_r = implicit_reference(*targs, save_pwr=True)
            b2 = {w: ga.fused_graph_attention(q, k, vw, y[w]) for w in ("shared", "per_head")}
            b2_want = {w: ga.graph_attention_plain(q, k, vw, y[w]) for w in b2}
        torch.cuda.synchronize()
        for name, t in [("B1", b1), ("B1 train out", out_t), ("B1 train pwr", pwr_t),
                        *((f"B2 {w}", t) for w, t in b2.items())]:
            if not torch.isfinite(t).all():
                fail(f"{name} not finite at R={R}, b={b}")
        row = dict(R=R, b=b, b1_plan=implicit_plan(b, R),
                   b2_plan=ga.tiling_plan(b, R, s["n"], s["H"], s["dh"], s["o"])._asdict())
        row["b1_err"] = (b1 - b1_want).abs().max().item()
        row["b1_underflow_heads_max"] = b1[0, 7, 1:].abs().max().item()
        row["b1_fully_masked_err"] = (
            (b1[-1] - x["vw"][-1].mean(0)[None]).abs().max().item() if b > 1 else 0.0)
        row["b1_train_out_err"] = (out_t - out_r).abs().max().item()
        row["b1_train_pwr_err"] = (pwr_t - pwr_r).abs().max().item()
        uniform = vw[0].mean(0)
        for w, got in b2.items():
            tol = GRAPH_RTOL * b2_want[w].abs().max().item()
            row[f"b2_{w}_err"] = (got - b2_want[w]).abs().max().item()
            checks = {"empty_row": (got[0, 3] - uniform).abs().max().item()}
            if b > 1:
                checks["padded"] = (got[-1] - vw[-1].mean(0)).abs().max().item()
            row[f"b2_{w}_degenerate"] = checks
            under = got[0, 7, 1:].abs().max().item()
            if w == "per_head":
                under = max(under, got[0, 9, 1:].abs().max().item())
            row[f"b2_{w}_underflow"] = under
            if not row[f"b2_{w}_err"] <= tol:
                fail(f"B2 vs plain max abs diff {row[f'b2_{w}_err']} > {tol} at R={R}, b={b}, "
                     f"{w} bias")
            if any(not v <= tol for v in checks.values()):
                fail(f"B2: degenerate rows {checks} not uniform at R={R}, b={b}, {w} bias")
            if under != 0.0:
                fail(f"B2: underflowing heads are not zero ({under}) at R={R}, b={b}, {w} bias")
        qs, ks, vs = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, vw))
        mask = y["shared"].permute(0, 2, 1, 3)
        fns = {
            "b1_ms": lambda: ia.fused_implicit_graph_attention(*args),
            "b1_plain_ms": lambda: ia.implicit_attention_plain(*args),
            "b1_train_ms": lambda: ia.KERNEL(*targs, save_pwr=True),
            "b1_train_plain_ms": lambda: ia.implicit_attention_plain(*targs, save_pwr=True),
            "b2_ms": lambda: ga.fused_graph_attention(q, k, vw, y["shared"]),
            "b2_plain_ms": lambda: ga.graph_attention_plain(q, k, vw, y["shared"]),
            "sdpa_ms": lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
        }
        with torch.no_grad():
            row.update(zip(fns, median_ms_interleaved(list(fns.values()))))
        out_bytes = nbytes(q) // q.shape[3] * vw.shape[3]
        for name, moved, flops in (
            ("b1", nbytes(*args, b1), implicit_flops(b, R)),
            ("b1_train", nbytes(*targs[:-2], targs[-1], out_t, pwr_t), implicit_flops(b, R)),
            ("b2", nbytes(q, k, vw, y["shared"]) + out_bytes, graph_flops(b, R)),
        ):
            bnd = bound(moved, flops)
            row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = bnd["bound_ms"], bnd["bound_by"]
        print("kernels at rows", json.dumps(row), flush=True)
        if not row["b1_err"] <= KERNEL_ATOL:
            fail(f"B1 vs plain max abs diff {row['b1_err']} > {KERNEL_ATOL} at R={R}, b={b}")
        if row["b1_underflow_heads_max"] != 0.0:
            fail(f"B1: underflowing heads are not zero at R={R}, b={b}")
        if not row["b1_fully_masked_err"] <= KERNEL_ATOL:
            fail(f"B1: fully masked example is not uniform at R={R}, b={b}")
        if not row["b1_train_out_err"] <= KERNEL_ATOL or not row["b1_train_pwr_err"] <= PWR_ATOL:
            fail(f"B1 train variant differs from the plain version at R={R}, b={b}: "
                 f"out {row['b1_train_out_err']}, pwr {row['b1_train_pwr_err']}")
        rows.append(row)
    return rows


def bf16_round(a):
    """f32 -> bf16 -> f32 in numpy, rounding to nearest even on the bits
    (finite inputs)."""
    import numpy as np

    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return r.view(np.float32)


def check_tables(device):
    """Phase 15: the synthetic train split of configs/butd_vqa.json held on
    the card at f32, bf16 and int8; one b=256 batch gathered at R=100 from
    each equals, bit for bit, numpy's widening (bf16) or dequantization
    (int8: q * rowmax/127) of the same rows, zeroed past each box count.
    Returns the tables' bytes per dtype."""
    import numpy as np
    import torch

    from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch, quantize_rows
    from tf_vqa_regat_tpu_torch.main import build_dataset

    cfg = full_width_config("implicit", ["--mode", "train"])
    ds = build_dataset(cfg, "train")
    R, sizes = 100, {}
    for dtype in ("float32", "bfloat16", "int8"):
        store = DeviceStore(ds, device, feature_dtype=dtype)
        img = store.images
        sizes[dtype] = nbytes(*(t for t in (img.features, img.feat_scale, img.norm_bb, img.bb,
                                            img.img_start, img.img_len) if t is not None))
        idx = next(store.epoch_indices(0, cfg.batch_size, True, cfg.seed))
        got = gather_batch(store, torch.from_numpy(idx).to(device), R)["features"].cpu().numpy()
        img = ds.entries.image_index[idx]
        pos = ds.store.pos_boxes
        n_box = np.minimum(pos[img, 1] - pos[img, 0], R)
        rows = np.clip(pos[img, 0][:, None] + np.arange(R), 0, len(ds.store.features) - 1)
        ok = (np.arange(R)[None, :] < n_box[:, None])[..., None]
        f = ds.store.features[rows]
        if dtype == "bfloat16":
            want = np.where(ok, bf16_round(f), 0.0).astype(np.float32)
        elif dtype == "int8":
            q, scale = quantize_rows(f.reshape(-1, f.shape[-1]))
            want = np.where(ok, q.reshape(f.shape).astype(np.float32), 0.0).astype(np.float32)
            want = want * scale.reshape(f.shape[:2])[..., None]
        else:
            want = np.where(ok, f, 0.0).astype(np.float32)
        same = np.array_equal(got.view(np.uint32), want.view(np.uint32))
        print(f"table {dtype}: {sizes[dtype]} B of image tables on the card; a b=256 gather "
              f"at R={R} equals numpy's bit for bit: {same} (max abs diff "
              f"{float(np.abs(got - want).max())})", flush=True)
        if not same:
            fail(f"{dtype} table: the gathered features differ from numpy's")
        del store
    print(f"synthetic train split ({len(ds.entries.question_ids)} questions, "
          f"{len(ds.store.features)} rois) image-table bytes {json.dumps(sizes)}", flush=True)
    return sizes


def check_bf16_step(device, smi):
    """Phase 16: one full-width b=256 train step of configs/butd_vqa.json at
    --compute_dtype bfloat16 against f32, the same parameters, batch and
    dropout masks, TF32 off: the loss within BF16_LOSS_RTOL and each
    trainable leaf's gradient gap over its largest magnitude; then the
    train step's time (CUDA events, median of 8 after 2 warm-up) at R = 36,
    64 and 100 in both dtypes. Returns the times."""
    import torch

    from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
    from tf_vqa_regat_tpu_torch.main import build_dataset
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
    from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
    from tf_vqa_regat_tpu_torch.train.step import train_forward, train_step

    cfg = full_width_config("implicit", ["--mode", "train"])
    ds = build_dataset(cfg, "train")
    store = DeviceStore(ds, device)
    idx = torch.from_numpy(next(store.epoch_indices(0, cfg.batch_size, True, cfg.seed)))
    idx = idx.to(device)
    models = {}
    for dtype in ("float32", "bfloat16"):
        models[dtype] = ReGAT(cfg.replace(compute_dtype=dtype), ds.ntoken, ds.v_dim,
                              ds.num_ans).to(device)
    models["bfloat16"].load_state_dict(models["float32"].state_dict())
    batch = gather_batch(store, idx, 100)
    mask = trainable_mask(models["float32"], False)
    loss, grads, logits = {}, {}, {}
    for dtype, model in models.items():
        names = [n for n, _ in model.named_parameters()]
        out, logits[dtype] = train_forward(model, batch, 0, cfg.seed)
        loss[dtype] = out.item()
        grads[dtype] = dict(zip(names, torch.autograd.grad(out, list(model.parameters()))))
    gap = abs(loss["bfloat16"] - loss["float32"]) / abs(loss["float32"])
    logits_gap = max_rel(logits["bfloat16"].detach(), logits["float32"].detach())
    leaves = {n: max_rel(grads["bfloat16"][n], grads["float32"][n])
              for n, t in mask.items() if t}
    print(f"bf16 vs f32 train step b={cfg.batch_size} R=100: loss {loss['bfloat16']} vs "
          f"{loss['float32']} (rel {gap}, limit {BF16_LOSS_RTOL}); answer logits {logits_gap} "
          f"of their largest magnitude apart; trainable leaves' gradient "
          f"gaps over their largest magnitude {json.dumps(leaves)}", flush=True)
    if not all(torch.isfinite(g).all() for g in grads["bfloat16"].values()):
        fail("bf16 train step: a gradient is not finite")
    if not gap <= BF16_LOSS_RTOL:
        fail(f"bf16 train step: loss differs from f32 by rel {gap} > {BF16_LOSS_RTOL}")
    del grads
    times = {}
    for R in (36, 64, 100):
        batch = gather_batch(store, idx, R)
        for dtype, model in models.items():
            opt = Adamax(model, trainable_mask(model, False), make_lr_schedule(
                cfg.base_lr, 16, cfg.lr_decay_rate, cfg.lr_decay_step), cfg.grad_clip)
            ms = []
            for step in range(10):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                train_step(model, opt, batch, step, cfg.seed)
                ev[1].record()
                ev[1].synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
            times[f"{dtype} R={R}"] = statistics.median(ms[2:])
    print(f"butd train step b={cfg.batch_size}, median ms (CUDA events, TF32 off) on {smi}: "
          f"{json.dumps(times)}", flush=True)
    return times


def zero_grad_leaves(model, cfg):
    """The trainable leaves whose true gradient is zero in this model's train
    step (see ZERO_GRAD_LEAVES), and the leaves trainable_mask freezes."""
    from tf_vqa_regat_tpu_torch.models.regat import trainable_mask

    zero = {n for n, t in trainable_mask(model, False).items() if not t}
    zero.update(ZERO_GRAD_LEAVES)
    if cfg.mutan_shared_qdrop or cfg.dropout == 0.0:
        zero.update(SHARED_QDROP_ZERO_GRAD_LEAVES)
    if cfg.dropout == 0.0:
        zero.update(DROPOUT0_ZERO_GRAD_LEAVES)
    return zero


def leaf_gaps(model, zero, got, want):
    """Per leaf: the gradient gap over the leaf's largest magnitude, or over
    the largest gradient of all leaves for a leaf in `zero`."""
    top = max(g.abs().max() for g in want)
    return {n: ((a - b).abs().max() / top).item() if n in zero else max_rel(a, b)
            for (n, _), a, b in zip(model.named_parameters(), got, want)}


def check_bf16_fusion_step(device, smi, family, extra=()):
    """Phase 16 for BAN and MuTAN (with `extra`, e.g. --mutan_shared_qdrop):
    the family's full-width b=256 model at --compute_dtype bfloat16, R = 100
    and 36, the same parameters, batch and dropout masks throughout: the
    kernel path against the plain path in bf16 (the loss within
    BF16_PATH_LOSS_RTOL, each trainable leaf's gradient as BF16_PATH_GRAD
    says, 2 B1 train launches per forward, the MuTAN formulation checked),
    the bf16 loss and logits against the f32 model's, then the bf16 train
    step's median time (CUDA events, 8 after 2 warm-up) and its peak device
    memory. Returns the row printed per R."""
    import torch

    from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
    from tf_vqa_regat_tpu_torch.main import build_dataset
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
    from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
    from tf_vqa_regat_tpu_torch.train.step import train_forward, train_step

    cfg = full_width_config(family, ["--mode", "train", "--compute_dtype", "bfloat16", *extra])
    label = " ".join([family, *extra, "bf16"])
    ds = build_dataset(cfg, "train")
    store = DeviceStore(ds, device)
    idx = torch.from_numpy(next(store.epoch_indices(0, cfg.batch_size, True, cfg.seed)))
    idx = idx.to(device)
    model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device)
    f32 = ReGAT(cfg.replace(compute_dtype="float32"), ds.ntoken, ds.v_dim, ds.num_ans)
    f32.load_state_dict(model.state_dict())
    f32.to(device)
    zero = zero_grad_leaves(model, cfg)
    trainable = [n for n, t in trainable_mask(model, False).items() if t]
    want_branches = ["reassociated" if cfg.mutan_shared_qdrop else "naive", "naive"]
    rows = {}
    for R in (100, 36):
        batch = gather_batch(store, idx, R)

        def loss_and_grads(m):
            loss, logits = train_forward(m, batch, 0, cfg.seed)
            return loss.detach(), logits.detach(), torch.autograd.grad(loss, list(m.parameters()))

        reset_counts()
        with mutan_branches() as branches:
            loss_k, logits_k, grads_k = loss_and_grads(model)
        launches = counts()
        with plain_kernels():
            loss_p, _, grads_p = loss_and_grads(model)
        loss_f, logits_f, grads_f = loss_and_grads(f32)
        kernel_vs_plain = leaf_gaps(model, zero, grads_k, grads_p)
        bf16_vs_f32 = leaf_gaps(model, zero, grads_p, grads_f)
        allowed = {n: max(2 * bf16_vs_f32[n], BF16_PATH_GRAD_FLOOR) for n in trainable}
        worst = max(trainable, key=lambda n: kernel_vs_plain[n] / allowed[n])
        finite = all(torch.isfinite(g).all() for g in grads_k)
        del grads_k, grads_p, grads_f
        loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        opt = Adamax(model, trainable_mask(model, False), make_lr_schedule(
            cfg.base_lr, 16, cfg.lr_decay_rate, cfg.lr_decay_step), cfg.grad_clip)
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ms = []
        for step in range(10):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            train_step(model, opt, batch, step, cfg.seed)
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        model.load_state_dict(saved)
        del opt, saved
        rows[R] = dict(loss_kernel=loss_k.item(), loss_plain=loss_p.item(), loss_rel=loss_err,
                       worst_leaf=worst, worst_leaf_kernel_vs_plain=kernel_vs_plain[worst],
                       worst_leaf_bf16_vs_f32=bf16_vs_f32[worst], loss_f32=loss_f.item(),
                       bf16_vs_f32_loss_rel=abs(loss_k.item() - loss_f.item()) / abs(loss_f.item()),
                       bf16_vs_f32_logits_rel=max_rel(logits_k, logits_f),
                       b1_launches_per_forward=launches, step_ms=statistics.median(ms[2:]),
                       peak_gb=peak_gb, branches=branches)
        print(f"{label} train step b={cfg.batch_size} R={R} on {smi}, TF32 off: "
              f"{json.dumps(rows[R])}", flush=True)
        if not finite:
            fail(f"{label} R={R}: a gradient is not finite")
        if family == "mutan" and branches != want_branches:
            fail(f"{label} R={R} ran the MuTAN formulations {branches}, expected {want_branches}")
        if launches["B1 train"] != 2 or sum(launches.values()) != 2:
            fail(f"{label} R={R}: launches per forward {launches}, expected 2 of B1 train")
        if not loss_err <= BF16_PATH_LOSS_RTOL:
            fail(f"{label} R={R}: kernel vs plain loss rel {loss_err} > {BF16_PATH_LOSS_RTOL}")
        if not kernel_vs_plain[worst] <= allowed[worst]:
            fail(f"{label} R={R}: {worst} gradient kernel vs plain {kernel_vs_plain[worst]} > "
                 f"{allowed[worst]} (twice its bf16-vs-f32 gap {bf16_vs_f32[worst]}, or "
                 f"{BF16_PATH_GRAD_FLOOR})")
        if not rows[R]["bf16_vs_f32_loss_rel"] <= BF16_LOSS_RTOL:
            fail(f"{label} R={R}: bf16 loss differs from f32 by rel "
                 f"{rows[R]['bf16_vs_f32_loss_rel']} > {BF16_LOSS_RTOL}")
    return rows


def check_grad_accum(device, smi, family, force_naive=False):
    """Phase 20 for one family: from the same parameters, one f32 train step
    of the full-width b=256 model at --dropout 0 with --grad_accum k = 1, 2,
    4 (MuTAN's naive formulation forced in place of the reassociated one,
    which dropout 0 would take): the gradient Adamax receives agrees with
    k = 1's as ACCUM_GRAD says, the loss within
    ACCUM_LOSS_RTOL, the parameters after the step as ACCUM_PARAM_ATOL says, B1
    train launches 2 k; then each k's median step time (CUDA events, 4
    after 2 warm-up) and peak device memory. Returns (the row printed per
    k, the launches of the checked steps)."""
    import torch

    from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
    from tf_vqa_regat_tpu_torch.main import build_dataset
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
    from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
    from tf_vqa_regat_tpu_torch.train.step import train_step

    cfg = full_width_config(family, ["--mode", "train", "--dropout", "0"])
    label = f"{family}{' naive' if force_naive else ''} --dropout 0"
    ds = build_dataset(cfg, "train")
    store = DeviceStore(ds, device)
    idx = next(store.epoch_indices(0, cfg.batch_size, True, cfg.seed))
    batch = gather_batch(store, torch.from_numpy(idx).to(device), cfg.resolved_num_rois())
    model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    zero = zero_grad_leaves(model, cfg)
    names = [n for n, _ in model.named_parameters()]
    checked = [n for n, t in trainable_mask(model, False).items() if t and n not in zero]
    schedule = make_lr_schedule(cfg.base_lr, 16, cfg.lr_decay_rate, cfg.lr_decay_step)
    rows, after, grads, path_launches = {}, {}, {}, []
    for k in (1, 2, 4):
        model.load_state_dict(init)
        opt = Adamax(model, trainable_mask(model, False), schedule, cfg.grad_clip)
        real_step = opt.step

        def spy(g, real_step=real_step, k=k):
            grads[k] = dict(zip(names, (t.clone() for t in g)))
            real_step(g)

        opt.step = spy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()  # the checked step starts here
        with mutan_branches(force_naive) as branches:
            m = train_step(model, opt, batch, 0, cfg.seed, k)
            after[k] = {n: p.detach().clone() for n, p in model.named_parameters()}
            launches = read_path_counts(cfg)
            path_launches.append(launches)
            opt.step = real_step
            ms = []
            for step in range(1, 7):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                train_step(model, opt, batch, step, cfg.seed, k)
                ev[1].record()
                ev[1].synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        top = max(g.abs().max().item() for g in grads[1].values())
        # np.allclose's form: the excess over rtol |g_1| + atol, in units of atol
        grad_gaps = {n: ((grads[k][n] - grads[1][n]).abs() - ACCUM_GRAD_RTOL * grads[1][n].abs()
                         ).max().item() / (ACCUM_GRAD_ATOL * top) for n in checked}
        worst_grad = max(grad_gaps, key=grad_gaps.get)
        moved = {n: (after[k][n] - after[1][n]).abs() for n in names}
        # where k = 1's gradient lies within the bound the gradients are held
        # to, its sign, and so Adamax's first step, is not determined
        undetermined = {n: grads[1][n].abs() <= 2 * ACCUM_GRAD_ATOL * top for n in names}
        over = sum(int(((d > ACCUM_PARAM_ATOL) & ~undetermined[n]).sum())
                   for n, d in moved.items())
        total = sum(d.numel() for d in moved.values())
        worst = max(names, key=lambda n: moved[n].max().item())
        free = sum(int(u.sum()) for u in undetermined.values())
        worst_free = max(moved[n][undetermined[n]].max().item() if undetermined[n].any() else 0.0
                         for n in names)
        rows[k] = dict(loss=float(m["loss"]), n=float(m["n"]), step_ms=statistics.median(ms[2:]),
                       peak_gb=peak_gb, launches=launches, worst_grad_leaf=worst_grad,
                       worst_grad_excess_in_atol=grad_gaps[worst_grad],
                       worst_grad_leaf_rel_vs_k1=max_rel(grads[k][worst_grad],
                                                         grads[1][worst_grad]),
                       largest_grad=top, worst_param_leaf=worst,
                       worst_param_abs_diff_vs_k1=moved[worst].max().item(),
                       params_over_atol=over, params=total, lr=schedule(0),
                       params_sign_undetermined=free,
                       worst_sign_undetermined_abs_diff=worst_free,
                       branches_replaced_by_naive=sorted(set(branches)) if force_naive else [])
        del moved
        print(f"{label} --grad_accum {k} b={cfg.batch_size} f32 on {smi}, TF32 off: "
              f"{json.dumps(rows[k])}", flush=True)
        want_launches = {"B1 eval": 0, "B1 train": 2 * k, "B2": 0, "B2 per-head": 0}
        if launches != want_launches:
            fail(f"{label} --grad_accum {k}: launches {launches}, expected {want_launches}")
        if force_naive and "reassociated" not in branches:
            fail(f"{label}: no MuTAN block took the reassociated formulation to replace")
        loss_rel = abs(rows[k]["loss"] - rows[1]["loss"]) / abs(rows[1]["loss"])
        if not loss_rel <= ACCUM_LOSS_RTOL:
            fail(f"{label} --grad_accum {k}: loss {rows[k]['loss']} vs k=1 {rows[1]['loss']} "
                 f"(rel {loss_rel} > {ACCUM_LOSS_RTOL})")
        if not grad_gaps[worst_grad] <= 1.0:
            fail(f"{label} --grad_accum {k}: {worst_grad} gradient differs from k=1 by more "
                 f"than {ACCUM_GRAD_RTOL} of it + {ACCUM_GRAD_ATOL} of the largest gradient")
        if over or not rows[k]["worst_param_abs_diff_vs_k1"] <= 2 * schedule(0):
            fail(f"{label} --grad_accum {k}: {over} of the {total - free} parameters whose "
                 f"gradient's sign is determined differ from k=1 by more than "
                 f"{ACCUM_PARAM_ATOL} (worst of all {worst}, {moved[worst].max().item()})")
        del opt
        if k != 1:  # k = 1's stay as the reference
            del grads[k], after[k]
    return rows, path_launches


def check_grad_accum_resume(tmp, smi):
    """Phase 20's resume: configs/butd_vqa.json at full width, b=256,
    `--grad_accum 2` with dropout on (phase 11's flags otherwise): (a)
    uninterrupted, then (b) preempted and (c) resumed; (c) must equal (a)
    bit for bit, with 2 x 2 B1 train launches per step over its 4 steps.
    Returns the launches of (a) and (c)."""
    from tf_vqa_regat_tpu_torch import main as port_main

    flags = ["--mode", "train", "--epochs", "2", "--synthetic_train_size", "1536",
             "--checkpoint_every_steps", "2", "--grad_accum", "2", "--train_block", "2"]
    reset_counts()  # the uninterrupted path starts here
    t0 = time.perf_counter()
    argv = entry_argv("implicit", os.path.join(tmp, "a"), *flags)
    if port_main.main(argv) is None:
        fail("the --grad_accum 2 run (a) was preempted")
    wall = time.perf_counter() - t0
    launches_a = read_path_counts(port_main.parse(argv)[0])
    uninterrupted = read_run(os.path.join(tmp, "a"))
    resumed, launches_c, _ = preempted_then_resumed(os.path.join(tmp, "b"), flags)
    diff, excess, metric, bits = run_distance(uninterrupted, resumed)
    print(f"--grad_accum 2 resume (c) vs uninterrupted (a, {wall:.1f} s on {smi}): params "
          f"max abs diff {diff}, metrics max rel diff {metric}, bit-equal {bits}; launches "
          f"of (a) {json.dumps(launches_a)}, of (c) {json.dumps(launches_c)}", flush=True)
    if not bits:
        fail(f"the resumed --grad_accum 2 run differs from the uninterrupted one: params "
             f"{diff}, metrics rel {metric}")
    cfg = full_width_config("implicit", ["--mode", "train"])
    passes = -(-cfg.synthetic_val_size // cfg.resolved_eval_batch())
    for run, launches, steps, epochs in (("(a)", launches_a, 12, 2), ("(c)", launches_c, 4, 1)):
        if launches != expected_launches("implicit", epochs * passes, 2 * steps):
            fail(f"--grad_accum 2 run {run}: launches {launches} for {steps} steps of 2 "
                 f"microbatches and {epochs * passes} eval passes")
    for k in ("a", "b"):
        shutil.rmtree(os.path.join(tmp, k, "checkpoints"))
    return [launches_a, launches_c]


def check_bench_settings(tmp, smi, family, extra=()):
    """Phase 17: `--mode train --epochs 1` then `--mode eval` under the
    family's config (with the flags `extra`) at the JAX bench's settings
    (BENCH_FLAGS): the launches at each bucket R equal 2 x (train steps +
    eval batches) of that bucket, as the store counts them (B1's train
    variant for the steps and eval variant for the batches, B2 for both),
    every step finite, the eval loss equal to the training run's last; the
    median step time per bucket. Returns (the launches of the train and eval
    paths, the median step ms per bucket, the written .npz)."""
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.data.store import DeviceStore

    argv = entry_argv(family, tmp, "--print_freq", "4", *BENCH_FLAGS, *extra)
    cfg = port_main.parse(argv + ["--mode", "train"])[0]
    buckets = cfg.parsed_roi_buckets()
    cpu = torch.device("cpu")
    steps = dict(zip(buckets, DeviceStore(port_main.build_dataset(cfg, "train"), cpu)
                     .bucketed_batch_counts(cfg.batch_size, buckets)))
    evals = dict(zip(buckets, DeviceStore(port_main.build_dataset(cfg, "val"), cpu)
                     .bucketed_batch_counts(cfg.resolved_eval_batch(), buckets)))

    def want(train):
        out = {}
        for R in buckets:
            if family in B1_FAMILIES:
                out[("B1 train", R)] = 2 * steps[R] if train else 0
                out[("B1 eval", R)] = 2 * evals[R]
            else:
                out[("B2", R)] = 2 * (evals[R] + (steps[R] if train else 0))
        return {k: v for k, v in out.items() if v}

    reset_counts()  # the train path starts here
    with timed_steps() as records:
        path = port_main.main(argv + ["--mode", "train", "--epochs", "1"])
    rows = rows_counts()
    launches = read_path_counts(cfg)
    torch.cuda.synchronize()
    per_bucket = {R: [ev[0].elapsed_time(ev[1]) for r, ev, *_ in records if r == R]
                  for R in buckets}
    losses = [float(loss) for _, _, loss, _, _ in records]
    # the steps that replayed a graph captured before them
    step_ms = {R: statistics.median(t) for R, t in (
        (R, [ev[0].elapsed_time(ev[1]) for r, ev, *_, cap in records if r == R and not cap])
        for R in buckets) if t}
    with open(os.path.join(tmp, "metrics.jsonl")) as fh:
        last = [json.loads(line) for line in fh][-1]
    label = f"{CONFIGS[family]} {' '.join(BENCH_FLAGS + tuple(extra))}"
    print(f"{label} --mode train: steps per bucket {json.dumps({R: len(t) for R, t in per_bucket.items()})} "
          f"(store: {json.dumps(steps)}), eval batches per bucket {json.dumps(evals)}; median "
          f"step ms per bucket (CUDA events) on {smi}, TF32 off: {json.dumps(step_ms)}; "
          f"launches by (kernel, R) {rows}; losses {losses}; last metrics {json.dumps(last)}",
          flush=True)
    if {R: len(t) for R, t in per_bucket.items()} != steps:
        fail(f"{label}: steps per bucket differ from the store's counts {steps}")
    if not all(map(math.isfinite, losses)):
        fail(f"{label}: a loss is not finite: {losses}")
    if rows != want(True):
        fail(f"{label} --mode train: launches {rows}, expected {want(True)}")
    reset_counts()  # the eval path starts here
    score, loss = port_main.main(argv + ["--mode", "eval", "--checkpoint", path])
    rows_eval = rows_counts()
    launches_eval = read_path_counts()
    rel = abs(loss - last["eval_loss"]) / abs(last["eval_loss"])
    print(f"{label} --mode eval: score {score} loss {loss} vs the training run's "
          f"{last['eval_loss']} (rel {rel}); launches by (kernel, R) {rows_eval}", flush=True)
    if not rel <= EVAL_LOSS_RTOL:
        fail(f"{label} --mode eval loss differs from the training run's by rel {rel}")
    if rows_eval != want(False):
        fail(f"{label} --mode eval: launches {rows_eval}, expected {want(False)}")
    return [launches, launches_eval], step_ms, path


def check_fixed36(tmp_root, smi, device):
    """Phase 18: configs/butd_vqa_fixed36.json at b=256 (train, 1 epoch), then
    eval, HTTP serve at b = 1, 8, 32 and predict, all at R=36, with f32 and
    then int8 feature tables (phases 8-10 and 12's checks). Returns the
    launches of its paths."""
    launches = []
    for extra in ((), ("--feature_dtype", "int8")):
        tmp = os.path.join(tmp_root, "fixed36" + "".join(extra[1:]))
        flags = ("--batch_size", "256", *extra)
        npz, train_launches, _ = check_entry_point(tmp, smi, "implicit", flags, FIXED36)
        serve_launches, _, _ = check_serve(npz, "implicit", extra, FIXED36)
        launches += [train_launches, serve_launches,
                     check_predict(tmp, smi, "implicit", npz, device, flags, FIXED36)]
        shutil.rmtree(os.path.join(tmp, "checkpoints"))
    rows = PATH_ROWS[-6:]
    if any(R != 36 for path in rows for _, R in path):
        fail(f"fixed-36 paths launched at other row counts: {rows}")
    return launches


# Phase 19's dataset: the reference layout at full width (2048-d features,
# 3,129 answers, 10-100 boxes per image), the feature files converted.
REAL_SPLITS = {
    "train": dict(num_images=1024, num_questions=4096, seed=0, semantic=True, spatial_seed=10),
    "val": dict(num_images=256, num_questions=1024, seed=1, semantic=True, spatial_seed=11,
                first_image_id=100000, first_question_id=100000),
    "test2015": dict(num_images=128, num_questions=512, seed=2, first_image_id=200000,
                     first_question_id=200000),
}
REAL_CP_QUESTIONS = 1024
MMAP_FLAGS = ("--mmap_features", "--feature_dtype", "bfloat16", "--packed_cache")


def write_real_dataset(root, smi):
    """Phase 19's dataset under `root`: train and val, the VQA-CP and Visual
    Genome files, then test2015 (whose questions replace the five that
    write_cp_vg writes for the TF-IDF pass). Returns its bytes on disk."""
    from tf_vqa_regat_tpu_torch.data.synthetic import write_cp_vg, write_dataset

    t0 = time.perf_counter()
    for name in ("train", "val"):
        write_dataset(root, name=name, v_dim=2048, num_ans=3129, box_range=(10, 101),
                      **REAL_SPLITS[name])
    write_cp_vg(root, num_cp_questions=REAL_CP_QUESTIONS)
    write_dataset(root, name="test2015", v_dim=2048, num_ans=3129, box_range=(10, 101),
                  **REAL_SPLITS["test2015"])
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    print(f"real-layout dataset written with numpy in {time.perf_counter() - t0:.1f} s "
          f"(host clock, on the host of the {smi}): "
          f"{size} bytes ({json.dumps({k: v['num_questions'] for k, v in REAL_SPLITS.items()})} "
          f"questions, {REAL_CP_QUESTIONS} per VQA-CP split)", flush=True)
    return size


@contextlib.contextmanager
def recorded_stores():
    """Each image-table build of a DeviceStore: (split, feature dtype,
    seconds to the table on the card, conversions run). A packed-cache hit
    runs no conversion."""
    import torch

    from tf_vqa_regat_tpu_torch.data import store as store_mod

    real_build, real_convert, builds, converted = (
        store_mod.image_store, store_mod.converted_chunks, [], [0])

    def convert(*args, **kw):
        converted[0] += 1
        return real_convert(*args, **kw)

    def build(ds, device, feature_dtype="float32", *args, **kw):
        before = converted[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images = real_build(ds, device, feature_dtype, *args, **kw)
        torch.cuda.synchronize()
        builds.append((ds.name, feature_dtype, time.perf_counter() - t0, converted[0] - before))
        return images

    store_mod.image_store, store_mod.converted_chunks = build, convert
    try:
        yield builds
    finally:
        store_mod.image_store, store_mod.converted_chunks = real_build, real_convert


def check_real_gather(root, device, family, extra=()):
    """One b=256 batch gathered at R=100 from the train split's store (the
    family's config, the flags `extra`) equals numpy's rows of the converted
    files bit for bit: features (bf16-rounded under --feature_dtype
    bfloat16), boxes, and the edge labels the batch carries (the file's
    `image_adj_matrix` for spatial, `semantic_adj_matrix` for semantic)."""
    import numpy as np
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.data.store import gather_batch
    from tf_vqa_regat_tpu_torch.train import loop

    cfg = port_main.parse(entry_argv(family, root, "--mode", "train", *extra, data=root))[0]
    train = port_main.build_datasets(cfg)[0]
    store = loop.build_store(cfg, train, device)
    idx = next(store.epoch_indices(0, cfg.batch_size, True, cfg.seed))
    got = gather_batch(store, torch.from_numpy(idx).to(device), 100)
    d = os.path.join(root, "Bottom-up-features-adaptive", "train")
    table = {k: np.load(os.path.join(d, k + ".npy"), mmap_mode="r")
             for k in ("image_features", "spatial_features", "image_bb", "pos_boxes")}
    img = train.entries.image_index[idx]
    pos = table["pos_boxes"]
    n_box = np.minimum(pos[img, 1] - pos[img, 0], 100)
    rows = np.clip(pos[img, 0][:, None] + np.arange(100), 0, len(table["image_features"]) - 1)
    ok = (np.arange(100)[None, :] < n_box[:, None])[..., None]

    def rows_of(key, widen=lambda x: x):
        return np.where(ok, widen(np.asarray(table[key][rows.reshape(-1)]).reshape(
            *rows.shape, -1)), 0.0).astype(np.float32)

    want = {"features": rows_of("image_features", bf16_round if cfg.feature_dtype == "bfloat16"
                                else (lambda x: x)),
            "norm_bb": rows_of("spatial_features"), "bb": rows_of("image_bb")}
    adj_key = {"spatial": "image_adj_matrix", "semantic": "semantic_adj_matrix"}.get(
        cfg.relation_type)
    if adj_key:
        want["adj_label"] = np.load(os.path.join(d, adj_key + ".npy"))[img].astype(np.int32)
    same = {k: bool(np.array_equal(got[k].cpu().numpy().view(np.uint32), w.view(np.uint32)))
            for k, w in want.items()}
    print(f"{CONFIGS[family]} {' '.join(extra)} real-layout gather, b={len(idx)} at R=100 "
          f"({cfg.feature_dtype} table): equal to numpy's rows of the converted files bit for "
          f"bit {json.dumps(same)}; batch keys {sorted(got)}", flush=True)
    if not all(same.values()) or (adj_key is None) == ("adj_label" in got):
        fail(f"{family} real-layout gather differs from the converted files: {same}")


def check_realdata(tmp_root, smi, device):
    """Phase 19: the entry point on a full-width dataset in the reference
    layout (no --synthetic). Returns the launches of its paths."""
    import numpy as np

    from tf_vqa_regat_tpu_torch.data.dictionary import Dictionary
    from tf_vqa_regat_tpu_torch.data.glove import tfidf_from_questions
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
    from tf_vqa_regat_tpu_torch.params import load_npz

    root = os.path.join(tmp_root, "real")
    write_real_dataset(root, smi)
    launches = []
    with recorded_stores() as builds:
        # butd_vqa.json (tfidf: true): train, eval, predict on test2015, serve
        tmp = os.path.join(tmp_root, "real_implicit")
        npz, train_launches, _ = check_entry_point(tmp, smi, "implicit", data=root)
        launches.append(train_launches)
        glove = np.load(os.path.join(root, "glove", "glove6b_init_300d.npy"))
        pad = np.zeros((1, glove.shape[1]), np.float32)
        d = Dictionary.load_from_file(os.path.join(root, "glove", "dictionary.pkl"))
        ntoken = d.ntoken
        tfidf, weights = tfidf_from_questions(["train", "val", "test2015"], d, root)
        init = {"w_emb/emb/table": np.concatenate([glove, pad]),
                "w_emb/emb_/table": np.concatenate(
                    [np.asarray(tfidf @ np.concatenate([glove, weights]), np.float32), pad])}
        cfg = full_width_config("implicit")
        mask = trainable_mask(ReGAT(cfg, ntoken, 2048, 3129), True)
        final = load_npz(npz)
        moved = {k: not np.array_equal(final[k], v) for k, v in init.items()}
        trainable = {k: mask[k.replace("/", ".")] for k in init}
        print(f"--tfidf: dictionary {ntoken} -> {d.ntoken} words; the word tables moved from "
              f"their GloVe init: {json.dumps(moved)}; trainable: {json.dumps(trainable)}",
              flush=True)
        if moved != trainable or not trainable["w_emb/emb_/table"]:
            fail(f"--tfidf: emb_ must train and each table move iff trainable: {moved}")
        launches.append(check_predict(tmp, smi, "implicit", npz, device, data=root))
        launches.append(check_serve(npz, "implicit", data=root)[0])
        shutil.rmtree(os.path.join(tmp, "checkpoints"))
        # spatial and semantic through B2, with the file's edge labels
        for family in ("spatial", "semantic"):
            tmp = os.path.join(tmp_root, "real_" + family)
            _, train_launches, _ = check_entry_point(tmp, smi, family, data=root)
            launches.append(train_launches)
            if LAST_TRAIN["adj_batches"] != LAST_TRAIN["steps"]:
                fail(f"{family}: {LAST_TRAIN['adj_batches']} of {LAST_TRAIN['steps']} train "
                     f"batches carried the file's edge labels")
            check_real_gather(root, device, family)
            shutil.rmtree(os.path.join(tmp, "checkpoints"))
        # the compositions
        tmp = os.path.join(tmp_root, "real_both_vg")
        _, train_launches, _ = check_entry_point(tmp, smi, "implicit", ("--use_both", "--use_vg"),
                                                 data=root)
        launches.append(train_launches)
        want = REAL_SPLITS["train"]["num_questions"] + REAL_SPLITS["val"]["num_questions"] + 6
        if (LAST_TRAIN["train"], LAST_TRAIN["train_name"]) != (want, "trainval+vg"):
            fail(f"--use_both --use_vg trained on {LAST_TRAIN}, expected {want} questions")
        tmp = os.path.join(tmp_root, "real_mutan_cp")
        _, train_launches, _ = check_entry_point(tmp, smi, "mutan", data=root, falling=False)
        launches.append(train_launches)
        if (LAST_TRAIN["train"], LAST_TRAIN["val_name"]) != (REAL_CP_QUESTIONS, "cp_test"):
            fail(f"vqa_cp trained on {LAST_TRAIN}")
        first = len(builds)
        # --mmap_features, bf16 tables through a packed cache, twice
        cache = os.path.join(tmp_root, "packed_cache")
        for run in ("miss", "hit"):
            n0 = len(builds)
            tmp = os.path.join(tmp_root, f"real_mmap_{run}")
            _, train_launches, _ = check_entry_point(tmp, smi, "implicit", (*MMAP_FLAGS, cache),
                                                     data=root)
            launches.append(train_launches)
            runs = builds[n0:]
            stamp = {f: os.path.getmtime(os.path.join(cache, f)) for f in os.listdir(cache)}
            if run == "miss":
                stamps = stamp
            print(f"{' '.join(MMAP_FLAGS)} DIR, {run} run: store builds (split, dtype, s to the "
                  f"card, conversions) {json.dumps(runs)} on {smi}; cache files {sorted(stamp)}",
                  flush=True)
            converted = sum(c for *_, c in runs)
            if (run == "hit") == bool(converted) or (run == "hit" and stamp != stamps):
                fail(f"packed cache {run} run converted {converted} tables; files {stamp}")
        check_real_gather(root, device, "implicit", (*MMAP_FLAGS, cache))
        print(f"store builds (split, dtype, s to the card, conversions), without a packed "
              f"cache, on {smi}: {json.dumps(builds[:first])}", flush=True)
    return launches


HOST_FLAGS = ("--data_mode", "host")
BF16_FLAGS = ("--feature_dtype", "bfloat16", "--compute_dtype", "bfloat16")
# --data_mode auto with a budget below every full-width synthetic split's
# tables (val ~0.06 GB at f32), so auto resolves to the host path
AUTO_SMALL = ("--data_mode", "auto", "--device_store_budget_gb", "0.05")


def median_s(fn, reps):
    """Median host-clock seconds of `reps` calls of fn, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def check_host_batches(device, smi, feature_dtype):
    """Phase 21's one-batch checks at full width (butd_vqa.json's synthetic
    train split, b=256, R=100) for one --feature_dtype: the host batch,
    copied and widened on the card, equals the device store's gather at the
    same indices bit for bit (f32, bf16), or (int8) equals the bf16 wire
    batch; the pack time with the C++ and the numpy row gather, and of
    the C++ pack the time in the gathers, in the bf16 rounding and the rest
    (which holds the interpreter lock); the copy of the pinned batch to the
    card (time, GB/s); 5,000 tiny launches alone and while a thread packs;
    and the feature-row gather alone in both versions (GB/s)."""
    import numpy as np
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.data import native
    from tf_vqa_regat_tpu_torch.data.loader import BatchLoader, widen_features
    from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
    from tf_vqa_regat_tpu_torch.train.loop import host_loader

    cfg = full_width_config("implicit", ["--mode", "train", *SHORT_TRAIN, "--feature_dtype",
                                         feature_dtype])
    ds = port_main.build_dataset(cfg, "train")
    loader = host_loader(cfg, ds, cfg.batch_size, True)
    plain = BatchLoader(ds, cfg.batch_size, cfg.resolved_num_rois(), True, cfg.seed,
                        feature_dtype=feature_dtype, native=False)
    idx = next(loader.epoch_indices(0))
    host = loader.empty_batch(pin_memory=True)
    pack_s = median_s(lambda: loader.pack(idx, host), 5)
    plain_s = median_s(lambda: plain.pack(idx), 3)
    # where a pack's time goes: the C++ gathers and (bf16) torch's rounding
    # run without the interpreter lock; the rest of the pack holds it
    real_gather, in_gather = native.gather_rows, []

    def timed_gather(*args, **kw):
        t0 = time.perf_counter()
        real_gather(*args, **kw)
        in_gather[-1] += time.perf_counter() - t0

    native.gather_rows = timed_gather
    try:
        for _ in range(5):
            in_gather.append(0.0)
            loader.pack(idx, host)
    finally:
        native.gather_rows = real_gather
    gather_s = statistics.median(in_gather)
    round_s = 0.0
    if loader.wire_dtype != torch.float32:
        f32 = torch.from_numpy(loader._scratch)
        round_s = median_s(lambda: host["features"].copy_(f32), 5)
    held_s = pack_s - gather_s - round_s
    if not all(torch.equal(a, b) for a, b in zip(loader.pack(idx).values(),
                                                  plain.pack(idx).values())):
        fail(f"{feature_dtype} host batch: the C++ and the numpy gather differ")
    moved = sum(t.numel() * t.element_size() for t in host.values())
    stream = torch.cuda.Stream(device)

    def copy():
        with torch.cuda.stream(stream):
            return {k: v.to(device, non_blocking=True) for k, v in host.items()}

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    h2d = []
    for _ in range(11):
        ev[0].record(stream)
        copy()
        ev[1].record(stream)
        ev[1].synchronize()
        h2d.append(ev[0].elapsed_time(ev[1]))
    h2d_ms = statistics.median(h2d[1:])
    line = (f"host batch b={cfg.batch_size} R={cfg.resolved_num_rois()} --feature_dtype "
            f"{feature_dtype} (wire {str(loader.wire_dtype).split('.')[-1]}, {moved} bytes): "
            f"pack {pack_s * 1e3:.3f} ms with the C++ gather, {plain_s * 1e3:.3f} ms with "
            f"numpy's (host clock, median; of the C++ pack, {gather_s * 1e3:.3f} ms in the "
            f"gathers and {round_s * 1e3:.3f} ms rounding to bf16, both without the "
            f"interpreter lock, and {held_s * 1e3:.3f} ms holding it); pinned copy to the "
            f"card {h2d_ms:.3f} ms "
            f"({moved / h2d_ms / 1e6:.2f} GB/s, CUDA events, median of 10) on {smi}")
    if feature_dtype == "int8":
        wire = host_loader(cfg.replace(feature_dtype="bfloat16"), ds, cfg.batch_size,
                           True).pack(idx)
        same = {k: bool(torch.equal(v, wire[k])) for k, v in loader.pack(idx).items()}
        print(f"{line}; equal to the bf16 wire batch {json.dumps(same)}", flush=True)
        if not all(same.values()):
            fail(f"the int8 host batch differs from the bf16 wire batch: {same}")
        return
    store = DeviceStore(ds, device, feature_dtype=feature_dtype, include_adj=False)
    want = gather_batch(store, torch.from_numpy(idx.astype(np.int32)).to(device),
                        cfg.resolved_num_rois())
    got = widen_features({k: v.to(device) for k, v in loader.pack(idx).items()})
    same = {k: bool(v.dtype == want[k].dtype and torch.equal(v, want[k])) for k, v in got.items()}
    print(f"{line}; on the card equal to the device store's gather bit for bit "
          f"{json.dumps(same)}", flush=True)
    if sorted(got) != sorted(want) or not all(same.values()):
        fail(f"{feature_dtype} host batch differs from the device gather: {same}")
    # what the producer costs a launch-bound main thread: 5,000 tiny
    # kernels launched alone, then while another thread packs batches
    x = torch.zeros(1, device=device)

    def launches():
        for _ in range(5000):
            x.add_(1.0)
        torch.cuda.synchronize()

    alone = median_s(launches, 5)
    stop, packs = threading.Event(), []

    def producer():
        while not stop.is_set():
            t0 = time.perf_counter()
            loader.pack(idx, host)
            packs.append(time.perf_counter() - t0)

    thread = threading.Thread(target=producer)
    thread.start()
    try:
        busy = median_s(launches, 5)
    finally:
        stop.set()
        thread.join()
    print(f"{feature_dtype} host batch: 5,000 launches take {alone * 1e3:.3f} ms alone and "
          f"{busy * 1e3:.3f} ms while a thread packs batches ({statistics.median(packs) * 1e3:.3f}"
          f" ms a pack meanwhile, {len(packs)} packs; host clock, median) on {smi}", flush=True)
    if feature_dtype == "float32":
        # the row gather alone, C++ against numpy, on the features table
        table = ds.store.features
        rows = loader._gather_table()[ds.entries.image_index[idx]].reshape(-1)
        out = np.empty((len(rows), table.shape[1]), table.dtype)
        nbytes_rows = out.nbytes
        cxx = median_s(lambda: native.gather_rows(table, rows, out), 5)
        ref = median_s(lambda: native.gather_rows_plain(table, rows, out), 3)
        print(f"host row gather (tf_vqa_regat_tpu_torch/csrc/pack.cc, {native.MAX_THREADS} "
              f"threads at most, {os.cpu_count()} cores) of {len(rows)} rows x "
              f"{table.shape[1]} f32 ({nbytes_rows} bytes): {cxx * 1e3:.3f} ms, "
              f"{nbytes_rows / cxx / 1e9:.2f} GB/s; numpy's {ref * 1e3:.3f} ms, "
              f"{nbytes_rows / ref / 1e9:.2f} GB/s (host clock, median) on the host of the "
              f"{smi}", flush=True)
    del store


def host_vs_device(tmp_root, smi, label, flags):
    """Phase 21 (a)/(b): butd_vqa.json `--mode train --epochs 1` (then
    `--mode eval`) with `flags`, in device mode and in host mode at
    --prefetch 2 and 0 (phase 8's checks each): each host run's final
    parameters and metrics equal the device run's at RESUME_RTOL /
    RESUME_ATOL. Returns {run: (output, launches)}."""
    runs, times = {}, {}
    for name, mode in (("device", ("--data_mode", "device")),
                       ("host", (*HOST_FLAGS, "--prefetch", "2")),
                       ("host, --prefetch 0", (*HOST_FLAGS, "--prefetch", "0"))):
        tmp = os.path.join(tmp_root, f"host_{label}_{name.split(',')[0]}{len(runs)}")
        _, launches, step_ms = check_entry_point(tmp, smi, "implicit",
                                                 (*SHORT_TRAIN, *flags, *mode))
        shutil.rmtree(os.path.join(tmp, "checkpoints"))
        runs[name] = (tmp, launches)
        times[name] = (step_ms, LAST_TRAIN["period_ms"])
    ref = read_run(runs["device"][0])
    for name in ("host", "host, --prefetch 0"):
        diff, excess, metric, bits = run_distance(ref, read_run(runs[name][0]))
        print(f"{label} {name} vs device: params max abs diff {diff} (excess over atol "
              f"{RESUME_ATOL} + rtol {RESUME_RTOL}: {excess}), metrics max rel diff {metric}, "
              f"bit-equal {bits}", flush=True)
        if not excess <= 0.0 or not metric <= RESUME_RTOL:
            fail(f"{label} {name} run differs from the device run: params excess {excess}, "
                 f"metrics rel {metric}")
    print(f"{label} step, median ms (CUDA events around the step; start to start, which "
          f"holds any wait for the batch) on {smi}: "
          + "; ".join(f"{k} {v[0]} / {v[1]}" for k, v in times.items()), flush=True)
    return runs


def check_host_streaming(tmp_root, smi, device):
    """Phase 21. Returns the launches of its paths."""
    import torch

    launches = []
    for dtype in ("float32", "bfloat16", "int8"):  # (a), (b), (c): one batch
        check_host_batches(device, smi, dtype)
        torch.cuda.empty_cache()
    f32 = host_vs_device(tmp_root, smi, "f32", ())  # (a)
    torch.cuda.empty_cache()
    bf16 = host_vs_device(tmp_root, smi, "bf16", BF16_FLAGS)  # (b)
    torch.cuda.empty_cache()
    launches += [r[1] for r in (*f32.values(), *bf16.values())]
    launches += check_auto_budget(tmp_root, smi, f32["device"][0])  # (d)
    launches += check_host_real_layout(tmp_root, smi)  # (e)
    launches += check_host_preemption(tmp_root, smi, f32["host"][0])  # (f)
    launches += check_host_ensemble(tmp_root, smi)  # (g)
    return launches


def check_auto_budget(tmp_root, smi, device_out):
    """Phase 21 (d): `--data_mode auto` under a 0.05 GB budget resolves to
    the host path (the log line), and `--mode eval` and `--mode predict` on
    the device run's .npz in `device_out` give its eval loss and device
    mode's answers; `--mode serve` is refused with the budget message.
    Returns the launches of the eval and predict paths."""
    from tf_vqa_regat_tpu_torch import main as port_main

    cfg = full_width_config("implicit", ["--mode", "train"])
    passes = -(-cfg.synthetic_val_size // cfg.resolved_eval_batch())
    npz = os.path.join(device_out, "implicit-butd-pretrained_model.npz")
    with open(os.path.join(device_out, "metrics.jsonl")) as fh:
        last = [json.loads(line) for line in fh][-1]
    out = os.path.join(tmp_root, "host_auto")
    launches = []
    reset_counts()  # the eval path starts here
    score, loss = port_main.main(entry_argv("implicit", out, "--mode", "eval", "--checkpoint",
                                            npz, *AUTO_SMALL))
    eval_launches = read_path_counts()
    launches.append(eval_launches)
    with open(os.path.join(out, "eval_log.txt")) as fh:
        resolved = [ln for ln in fh.read().splitlines() if ln.startswith("[data]")]
    answers = {}
    for name, mode in (("auto", AUTO_SMALL), ("device", ("--data_mode", "device"))):
        reset_counts()  # the predict path starts here
        path = port_main.main(entry_argv("implicit", os.path.join(out, name), "--mode",
                                         "predict", "--checkpoint", npz, *mode))
        launches.append(read_path_counts())
        if launches[-1] != expected_launches("implicit", passes):
            fail(f"{name} predict: launches {launches[-1]} for {passes} passes")
        with open(path) as fh:
            answers[name] = {d["question_id"]: d["answer"] for d in json.load(fh)}
    differ = sum(answers["auto"].get(q) != a for q, a in answers["device"].items())
    try:
        port_main.build_server(entry_argv("implicit", out, "--mode", "serve", "--checkpoint",
                                          npz, "--serve_port", "0", *AUTO_SMALL))
        refused = None
    except ValueError as e:
        refused = str(e)
    rel = abs(loss - last["eval_loss"]) / abs(last["eval_loss"])
    print(f"{' '.join(AUTO_SMALL)}: {resolved}; --mode eval loss {loss} vs the device run's "
          f"{last['eval_loss']} (rel {rel}), launches {json.dumps(eval_launches)}; --mode "
          f"predict answers differing from device mode's: {differ} of {len(answers['device'])}; "
          f"--mode serve refused: {refused!r}", flush=True)
    if len(resolved) != 1 or "data=host (--data_mode auto)" not in resolved[0]:
        fail(f"--data_mode auto under a 0.05 GB budget resolved {resolved}")
    if not rel <= EVAL_LOSS_RTOL or eval_launches != expected_launches("implicit", passes):
        fail(f"auto (host) eval: loss rel {rel}, launches {eval_launches}")
    if differ or len(answers["auto"]) != len(answers["device"]):
        fail(f"auto (host) predict: {differ} answers differ from device mode's")
    if refused is None or "--device_store_budget_gb" not in refused:
        fail(f"serve over the budget was not refused with the budget message: {refused!r}")
    return launches


def check_host_real_layout(tmp_root, smi):
    """Phase 21 (e): spatial_vqa.json `--data_mode host --mmap_features` on
    phase 19's dataset, train and eval through B2: every train batch
    carries the file's labels, and the run equals phase 19's device run.
    Returns the launches of the train path."""
    root = os.path.join(tmp_root, "real")
    tmp = os.path.join(tmp_root, "real_spatial_host")
    _, launches, _ = check_entry_point(tmp, smi, "spatial", (*HOST_FLAGS, "--mmap_features"),
                                       data=root)
    if LAST_TRAIN["adj_batches"] != LAST_TRAIN["steps"]:
        fail(f"spatial host: {LAST_TRAIN['adj_batches']} of {LAST_TRAIN['steps']} train "
             f"batches carried the file's edge labels")
    diff, excess, metric, bits = run_distance(
        read_run(os.path.join(tmp_root, "real_spatial"), "spatial-butd"),
        read_run(tmp, "spatial-butd"))
    print(f"spatial_vqa.json --data_mode host --mmap_features on the real layout vs phase 19's "
          f"device run: params max abs diff {diff} (excess {excess}), metrics max rel diff "
          f"{metric}, bit-equal {bits}; {LAST_TRAIN['adj_batches']} of {LAST_TRAIN['steps']} "
          f"train batches with the file's labels", flush=True)
    if not excess <= 0.0 or not metric <= RESUME_RTOL:
        fail(f"spatial host run on the real layout differs from device mode's: {diff}")
    shutil.rmtree(os.path.join(tmp, "checkpoints"))
    return [launches]


def check_host_preemption(tmp_root, smi, host_out):
    """Phase 21 (f): a host-mode butd run preempted at step 4 by
    REGAT_FAULT_PREEMPT_STEP, then resumed, equals the uninterrupted host
    run in `host_out` bit for bit, and leaves no prefetch thread; a
    device-written step checkpoint resumed under --data_mode host is
    refused. Returns the launches of the resumed path."""
    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt

    cfg = full_width_config("implicit", ["--mode", "train"])
    passes = -(-cfg.synthetic_val_size // cfg.resolved_eval_batch())
    flags = ("--mode", "train", "--epochs", "1", *SHORT_TRAIN, "--checkpoint_every_steps", "2")
    outs = {k: os.path.join(tmp_root, f"host_preempt_{k}") for k in ("host", "device")}
    os.environ["REGAT_FAULT_PREEMPT_STEP"] = "4"
    try:
        for k, mode in (("host", HOST_FLAGS), ("device", ("--data_mode", "device"))):
            if port_main.main(entry_argv("implicit", outs[k], *flags, *mode)) is not None:
                fail(f"the {k} run with REGAT_FAULT_PREEMPT_STEP=4 was not preempted")
    finally:
        del os.environ["REGAT_FAULT_PREEMPT_STEP"]
    meta = ckpt.restore_meta_full(outs["host"])
    if (meta or {}).get("step_in_epoch") != 4 or meta["run"]["data_mode"] != "host":
        fail(f"preempted host run left meta {meta}")
    alive = [t.name for t in threading.enumerate() if t.name == "regat-prefetch"]
    reset_counts()  # the resumed path starts here
    argv = entry_argv("implicit", outs["host"], *flags, *HOST_FLAGS, "--resume")
    if port_main.main(argv) is None:
        fail("the resumed host run was preempted")
    launches = read_path_counts(port_main.parse(argv)[0])
    diff, excess, metric, bits = run_distance(read_run(host_out), read_run(outs["host"]))
    try:
        port_main.main(entry_argv("implicit", outs["device"], *flags, *HOST_FLAGS, "--resume"))
        across = None
    except ValueError as e:
        across = str(e)
    print(f"host run preempted at step 4 (meta {json.dumps(meta)}), prefetch threads alive "
          f"after it: {alive}; resumed vs uninterrupted host run: params max abs diff {diff}, "
          f"metrics max rel diff {metric}, bit-equal {bits}; launches {json.dumps(launches)}; "
          f"a device-written step checkpoint resumed under --data_mode host: {across!r}",
          flush=True)
    if not bits:
        fail(f"the resumed host run differs from the uninterrupted one: {diff}, {metric}")
    if alive:
        fail(f"the preempted run left prefetch threads running: {alive}")
    if launches != expected_launches("implicit", passes, 2):
        fail(f"resumed host run: launches {launches} for 2 steps and {passes} passes")
    if across is None or "data_mode" not in across:
        fail(f"a device-written mid-epoch checkpoint was resumed under host mode: {across!r}")
    for k in outs.values():
        shutil.rmtree(os.path.join(k, "checkpoints"))
    return [launches]


def check_host_ensemble(tmp_root, smi):
    """Phase 21 (g): phase 13's ensemble over one shared host stream: B1 and
    B2 launches per pass, the score equal to device mode's, and batch by
    batch the averaged probabilities within ENSEMBLE_PROB_ATOL of the device
    path's, the batches equal. Returns its launches."""
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main

    argv = entry_argv("semantic", os.path.join(tmp_root, "host_ensemble"), "--mode",
                      "ensemble_eval", "--ensemble_checkpoints", LAST_ENSEMBLE["spec"],
                      *HOST_FLAGS)
    reset_counts()  # the ensemble path starts here
    t0 = time.perf_counter()
    score = port_main.main(argv)
    wall = time.perf_counter() - t0
    launches = read_path_counts()
    p = LAST_ENSEMBLE["passes"]
    want = {"B1 eval": 2 * p, "B1 train": 0, "B2": 4 * p, "B2 per-head": 0}
    # the members' averaged probabilities and the batches, batch by batch,
    # from the host stream and from the device store
    from tf_vqa_regat_tpu_torch.train import ensemble
    from tf_vqa_regat_tpu_torch.train.logging import Logger

    cfg = port_main.parse(argv)[0]
    ds = port_main.build_datasets(cfg)[1]
    members = ensemble.load_members(cfg, ds, torch.device("cuda", 0),
                                    Logger(os.path.join(tmp_root, "host_ensemble", "cmp.txt")))
    sources = ensemble.member_adj_sources(members, ds)
    passes = [ensemble._host_passes, ensemble._resident_passes]
    diff, same, n = 0.0, True, 0
    for (p_host, b_host), (p_dev, b_dev) in zip(*(f(cfg, ds, torch.device("cuda", 0), members,
                                                      sources) for f in passes)):
        diff = max(diff, (p_host - p_dev).abs().max().item())
        same = same and all(torch.equal(b_host[k], b_dev[k]) for k in b_dev)
        n += 1
    print(f"ensemble --data_mode host: score {score} vs device mode's {LAST_ENSEMBLE['score']}"
          f"; averaged probabilities over {n} batches, host stream vs device store: max abs "
          f"diff {diff}, batches equal {same}; {wall:.3f} s (host clock, loads included) on "
          f"{smi}; launches {json.dumps(launches)}", flush=True)
    if launches != want or abs(score - LAST_ENSEMBLE["score"]) > 1e-6 * score:
        fail(f"host ensemble: score {score}, launches {launches} (want {want})")
    if n != p or not same or diff > ENSEMBLE_PROB_ATOL:
        fail(f"host ensemble: {n} batches, probabilities differ by {diff}, batches equal {same}")
    return [launches]


# Phase 22: the train steps held graphed against eager (bit for bit), then
# timed: (family, extra flags, R, data path)
GRAPH_CHECKS = (("implicit", (), 36, "device"), ("implicit", (), 100, "device"),
                ("implicit", ("--compute_dtype", "bfloat16"), 36, "device"),
                ("implicit", ("--compute_dtype", "bfloat16"), 100, "device"),
                ("spatial", (), 100, "device"),
                ("implicit", ("--grad_accum", "2"), 100, "device"))
GRAPH_TIMINGS = tuple((family, extra, R, path) for R in (36, 100) for family, extra, path in (
    ("ban", ("--compute_dtype", "bfloat16"), "device"),
    ("implicit", ("--grad_accum", "4"), "device"),
    ("implicit", ("--feature_dtype", "bfloat16", "--compute_dtype", "bfloat16"), "host")))
GRAPH_STEPS = 6  # one block of the synthetic 1,536-question split
GRAPH_SPLITS = {}


def graph_setup(device, family, extra, R, path):
    """(config, train split, device store or None on the host path) of a
    phase-22 row: the family's full widths, b=256, 1,536 questions."""
    from tf_vqa_regat_tpu_torch.data.store import DeviceStore
    from tf_vqa_regat_tpu_torch.main import build_dataset

    flags = ["--mode", "train", "--num_rois", str(R), *SHORT_TRAIN, *extra]
    cfg = full_width_config(family, flags + (["--data_mode", "host"] if path == "host" else []))
    # the rows' configs draw one synthetic split: made once
    key = (cfg.adaptive, cfg.relation_type == "semantic")
    if key not in GRAPH_SPLITS:
        GRAPH_SPLITS[key] = build_dataset(cfg, "train")
    ds = GRAPH_SPLITS[key]
    store = None if path == "host" else DeviceStore(
        ds, device, feature_dtype=cfg.feature_dtype, include_adj=cfg.relation_type != "implicit")
    return cfg, ds, store


def graph_train_steps(device, cfg, ds, store, graphed):
    """GRAPH_STEPS train steps of the full-width model (seeded init, dropout
    on) through TrainSteps, from the device store or, with `store` None,
    the host path; then GRAPH_STEPS more, timed (host clock to a
    synchronise): -> (params, moments, the first steps' metrics and counts;
    ms per step; the capture seconds; the peak device memory in GB; the
    first steps' launches)."""
    import numpy as np
    import torch

    from tf_vqa_regat_tpu_torch.data.loader import prefetch_to_device
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
    from tf_vqa_regat_tpu_torch.train.loop import host_loader
    from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
    from tf_vqa_regat_tpu_torch.train.step import TrainSteps

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device)
    opt = Adamax(model, trainable_mask(model, False), make_lr_schedule(
        cfg.base_lr, GRAPH_STEPS, cfg.lr_decay_rate, cfg.lr_decay_step), cfg.grad_clip)
    train = TrainSteps(model, opt, cfg, device, store, graphed)
    if store is None:
        loader = host_loader(cfg, ds, cfg.batch_size, True)

        def block(epoch):
            out = []
            with contextlib.closing(prefetch_to_device(loader, device, epoch)) as batches:
                for batch in batches:
                    out.append({k: v.clone() for k, v in train.batch(batch).items()})
            return out
    else:
        blk = np.stack(list(store.epoch_indices(0, cfg.batch_size, True, cfg.seed)))
        R = cfg.resolved_num_rois()

        def block(epoch):
            return [{k: v.clone() for k, v in train.block(R, blk, len(blk)).items()}]

    reset_counts()
    first = block(0)
    launches = {**counts(), "B2 backward": backward_launches("b2")}
    torch.cuda.synchronize()
    state = {"params": [p.detach().clone() for p in opt.params],
             "mu": [t.clone() for t in opt.mu], "nu": [t.clone() for t in opt.nu],
             "metrics": first, "count": (opt.count, int(opt.count_t))}
    t0 = time.perf_counter()
    block(1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / GRAPH_STEPS
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    return state, ms, train.graphs.capture_seconds(), peak, launches


def check_graph_row(device, smi, family, extra, R, path, held=True):
    """One row of phase 22 (a): GRAPH_STEPS train steps graphed against
    eager from the same seeded init, bit for bit where `held`, and the
    timings of both -> (graphed ms, eager ms, capture s, peak GB graphed,
    eager)."""
    import torch

    label = f"{CONFIGS[family]} {' '.join(extra)} R={R} {path}".replace("  ", " ")
    cfg, ds, store = graph_setup(device, family, extra, R, path)
    g, g_ms, capture, g_peak, g_launch = graph_train_steps(device, cfg, ds, store, True)
    e, e_ms, _, e_peak, e_launch = graph_train_steps(device, cfg, ds, store, False)
    del store
    torch.cuda.empty_cache()
    equal = {k: all(torch.equal(a, b) for a, b in zip(g[k], e[k]))
             for k in ("params", "mu", "nu")}
    equal["metrics"] = all(torch.equal(a[k], b[k]) for a, b in zip(g["metrics"], e["metrics"])
                           for k in a)
    diff = max(float((a - b).abs().max()) for a, b in zip(g["params"], e["params"]))
    kernel = "B1 train" if family in B1_FAMILIES else "B2"
    steps = GRAPH_STEPS
    want = {n: 0 for n in g_launch}
    want[kernel] = 2 * cfg.grad_accum * steps
    if kernel == "B2":  # one backward per forward launch under grad
        want["B2 backward"] = want[kernel]
    print(f"graphs {label}: {steps} steps graphed vs eager: bit-equal "
          f"{json.dumps(equal)} (params max abs diff {diff}), counts {g['count']} / "
          f"{e['count']}; launches graphed {json.dumps(g_launch)}, eager "
          f"{json.dumps(e_launch)}; ms/step (host clock, {steps} steps after the first "
          f"{steps}) graphed {g_ms:.3f}, eager {e_ms:.3f}; capture (warm-up + capture) "
          f"{json.dumps({str(k): round(v, 3) for k, v in capture.items()})} s; peak "
          f"memory graphed {g_peak:.2f} GB, eager {e_peak:.2f} GB; on {smi}", flush=True)
    if g_launch != want or e_launch != want:
        fail(f"graphs {label}: launches graphed {g_launch}, eager {e_launch}, want {want}")
    if held and not all(equal.values()):
        fail(f"graphs {label}: graphed and eager steps differ: {equal}, params {diff}")
    if g["count"] != e["count"] or g["count"] != (steps, steps):
        fail(f"graphs {label}: step counts {g['count']} / {e['count']}")
    return g_ms, e_ms, capture, g_peak, e_peak


def check_graphs_train(device, smi):
    """Phase 22 (a): graphed against eager train steps, bit for bit, and the
    timings of both. Returns {label: (graphed ms, eager ms, capture s, peak
    GB graphed, eager)}."""
    rows = {}
    for family, extra, R, path in GRAPH_CHECKS + GRAPH_TIMINGS:
        label = f"{CONFIGS[family]} {' '.join(extra)} R={R} {path}".replace("  ", " ")
        rows[label] = check_graph_row(device, smi, family, extra, R, path,
                                      (family, extra, R, path) in GRAPH_CHECKS)
    return rows


def check_graphs_eval_serve(tmp, smi, device, npz):
    """Phase 22 (b): eval, predict, the ensemble and serve graphed against
    eager (metrics, answers and the score equal; served answers and
    confidences equal), with the eval pass's and each serve engine call's
    times (host clock) in both, and 2 launches per eval forward pass."""
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.serve import InferenceEngine
    from tf_vqa_regat_tpu_torch.train import loop
    from tf_vqa_regat_tpu_torch.train.ensemble import run_ensemble_eval
    from tf_vqa_regat_tpu_torch.train.logging import Logger

    cfg = port_main.parse(entry_argv("implicit", tmp, "--mode", "eval"))[0]
    ds = port_main.build_datasets(cfg)[1]
    model = port_main.load_model(cfg.replace(checkpoint=npz["implicit"]), ds).to(device)
    logger = Logger(os.path.join(tmp, "graphs_log.txt"))
    evals, passes = {}, -(-len(ds) // cfg.resolved_eval_batch())
    for graphed in (True, False):
        data = loop._DataPath(cfg, None, ds, device, logger)
        steps = data.eval_steps_of(model, graphed)
        reset_counts()
        first = loop._run_eval(steps, data, cfg, 0, logger, device)
        launches = counts()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = loop._run_eval(steps, data, cfg, 0, logger, device)
            times.append((time.perf_counter() - t0) * 1e3)
        evals[graphed] = (first[:2], again[:2], statistics.median(times), launches,
                          steps.graphs.capture_seconds())
        del steps, data
    (g, e) = evals[True], evals[False]
    print(f"graphs eval pass ({passes} batches of {cfg.resolved_eval_batch()}, eval_block "
          f"{cfg.eval_block}): graphed (score, loss) {g[0]}, eager {e[0]}; ms per pass "
          f"(host clock, median of 3) graphed {g[2]:.3f}, eager {e[2]:.3f}; capture "
          f"{json.dumps({str(k): round(v, 3) for k, v in g[4].items()})} s; launches graphed "
          f"{json.dumps(g[3])}, eager {json.dumps(e[3])} on {smi}", flush=True)
    want = expected_launches("implicit", passes)
    if g[0] != e[0] or g[1] != g[0] or g[3] != want or e[3] != want:
        fail(f"graphs eval: graphed {g}, eager {e}, launches want {want}")

    files = {}
    for graphed in (True, False):
        out = os.path.join(tmp, f"predict_{graphed}")
        path = loop.run_prediction(cfg.replace(output=out), ds, model, device, logger, graphed)
        with open(path) as fh:
            files[graphed] = json.load(fh)
    print(f"graphs predict: {len(files[True])} answers, graphed equal to eager "
          f"{files[True] == files[False]}", flush=True)
    if files[True] != files[False]:
        fail("graphs predict: graphed and eager answers differ")

    ecfg = port_main.parse(entry_argv("semantic", tmp, "--mode", "ensemble_eval",
                                      "--ensemble_checkpoints", LAST_ENSEMBLE["spec"]))[0]
    eds = port_main.build_dataset(ecfg)
    scores = {g: run_ensemble_eval(ecfg, eds, device, logger, g) for g in (True, False)}
    print(f"graphs ensemble: score graphed {scores[True]}, eager {scores[False]}", flush=True)
    if scores[True] != scores[False] or scores[True] != LAST_ENSEMBLE["score"]:
        fail(f"graphs ensemble: scores {scores}, phase 13's {LAST_ENSEMBLE['score']}")

    questions = ["what color is the car ?", "how many people are on the left ?",
                 "is the man on the dog ?", "what is the woman in ?"]
    ids = sorted(int(i) for i in ds.entries.image_ids)[:40]
    served, latency = {}, {}
    for graphed in (True, False):
        engine = InferenceEngine(cfg, ds, model, device, graphed=graphed)
        served[graphed] = [engine.infer([questions[i % 4] for i in range(B)],
                                        [ids[i % len(ids)] for i in range(B)])
                           for B in engine.batch_sizes]
        for B in engine.batch_sizes:
            qs, im = [questions[i % 4] for i in range(B)], [ids[i % len(ids)] for i in range(B)]
            runs = []
            for _ in range(23):
                t0 = time.perf_counter()
                engine.infer(qs, im)
                runs.append((time.perf_counter() - t0) * 1e3)
            latency.setdefault(B, {})["graphed" if graphed else "eager"] = statistics.median(
                runs[3:])
        del engine
    print(f"graphs serve engine call ms (host clock, median of 20) by batch size "
          f"{json.dumps(latency)}; answers and confidences graphed equal to eager "
          f"{served[True] == served[False]} on {smi}", flush=True)
    if served[True] != served[False]:
        fail("graphs serve: graphed and eager answers differ")
    logger.close()


# phase 23: data parallelism. (b)'s flags: butd's full width, b = 256 (128 a
# rank), 6 steps in blocks of 2 with a step checkpoint every 2, dropout off
DP_FLAGS = ("--synthetic_train_size", "1536", "--synthetic_val_size", "256", "--dropout", "0",
            "--train_block", "2", "--checkpoint_every_steps", "2", "--mode", "train",
            "--epochs", "1")
# per-epoch metrics of 2 ranks against 1: the same gradient summed in
# another order (two halves of the batch, then their sum), through the
# full-width model for 6 steps, as phase 7 holds one step's loss summed in
# another order (LOSS_RTOL). tests/test_torch_dp_entry.py holds the small
# CPU model to 1e-5; at full width on an H100 the eval loss of 2 ranks read
# 2.3e-5 from 1 rank's after the loss fell from 2,169 to 35 in 6 steps
DP_METRIC_RTOL = LOSS_RTOL
# JAX's data-parallel parameter tolerance (tests/test_parallel.py), printed
# for 2 ranks against 1: not held, since Adamax moves a leaf whose true
# gradient is zero by about lr times the sign of its rounding noise
DP_PARAM_RTOL, DP_PARAM_ATOL = 2e-3, 1e-4
DP_STEPS = 6


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def nccl_world_one():
    """torchrun's variables for one rank and REGAT_AUTO_DISTRIBUTED=1, so that
    each `main.main` call opens (and closes) an NCCL group of one; each
    rendezvous on a fresh port. Yields the (opened, backend, world size) of
    every group the entry point opened."""
    import torch.distributed as dist

    from tf_vqa_regat_tpu_torch.parallel import distributed

    env = dict(REGAT_AUTO_DISTRIBUTED="1", RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1")
    saved = {k: os.environ.get(k) for k in [*env, "MASTER_PORT"]}
    real, groups = distributed.maybe_initialize, []

    def spy(device_type="cuda"):
        os.environ["MASTER_PORT"] = str(free_port())
        opened = real(device_type)
        groups.append((opened, dist.get_backend(), dist.get_world_size()))
        return opened

    os.environ.update(env)
    distributed.maybe_initialize = spy
    try:
        yield groups
    finally:
        distributed.maybe_initialize = real
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def allreduce_ms(flat, reps=20):
    """Median ms of the all-reduce of `flat` alone: CUDA events under NCCL,
    the host clock to a synchronise under gloo (which stages it through the
    host)."""
    import torch
    import torch.distributed as dist

    out = []
    for _ in range(reps + 3):
        torch.cuda.synchronize()
        if dist.get_backend() == "nccl":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            dist.all_reduce(flat)
            ev[1].record()
            torch.cuda.synchronize()
            out.append(ev[0].elapsed_time(ev[1]))
        else:
            t0 = time.perf_counter()
            dist.all_reduce(flat)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out[3:])


def dp_step_times(device, smi):
    """(a): the graphed b=256 butd step from the device store with no group
    and in an NCCL group of one (its gradient sums all-reduced between two
    graphs), from the same seeded parameters, in turns; the all-reduce's
    bytes and its time alone."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
    from tf_vqa_regat_tpu_torch.parallel.mesh import Mesh
    from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule
    from tf_vqa_regat_tpu_torch.train.step import TrainSteps

    cfg, ds, store = graph_setup(device, "implicit", (), 100, "device")
    blk = np.stack(list(store.epoch_indices(0, cfg.batch_size, True, cfg.seed)))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        steps = {}
        for group in (False, True):
            model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device)
            opt = Adamax(model, trainable_mask(model, False), make_lr_schedule(
                cfg.base_lr, DP_STEPS, cfg.lr_decay_rate, cfg.lr_decay_step), cfg.grad_clip)
            steps[group] = TrainSteps(model, opt, cfg, device, store, mesh=Mesh(1, group=group))
            steps[group].block(100, blk, len(blk))  # captures
        ms = {False: [], True: []}
        for _ in range(3):
            for group, train in steps.items():
                idx = torch.from_numpy(blk).to(device)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(blk) + 1)]
                ev[0].record()
                for j in range(len(blk)):
                    train.step(100, {"idx": idx[j]})
                    ev[j + 1].record()
                torch.cuda.synchronize()
                ms[group] += [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        flat = steps[True].sums.flat
        reduce_ms = allreduce_ms(flat)
    finally:
        dist.destroy_process_group()
    del steps, store
    torch.cuda.empty_cache()
    out = {"step_ms_no_group": statistics.median(ms[False]),
           "step_ms_nccl_group": statistics.median(ms[True]),
           "allreduce_ms": reduce_ms, "allreduce_bytes": flat.numel() * 4}
    print(f"dp (a) butd b=256 graphed step, median of {len(ms[True])} (CUDA events, TF32 "
          f"off) on {smi}: no group {out['step_ms_no_group']:.3f} ms, NCCL group of one "
          f"{out['step_ms_nccl_group']:.3f} ms (two graphs and the all-reduce between them); "
          f"the all-reduce of {out['allreduce_bytes']} bytes (every parameter's gradient and "
          f"3 sums) alone {reduce_ms:.4f} ms (NCCL, one rank, CUDA events)", flush=True)
    return out


def check_dp_nccl(tmp, smi, device):
    """(a): butd_vqa.json at full width, b=256, `--data_mode sharded` through
    `main.main` in an NCCL group of one: train (phase 8's checks), eval
    (9's) and predict (12's). Returns the paths' launches."""
    with nccl_world_one() as groups:
        npz, train_launches, _ = check_entry_point(
            tmp, smi, "implicit", SHORT_TRAIN + ("--data_mode", "sharded"))
        predict_launches = check_predict(tmp, smi, "implicit", npz, device,
                                         ("--data_mode", "sharded"))
    with open(os.path.join(tmp, "log.txt")) as fh:
        sharded = "[data] data=sharded (--data_mode sharded)" in fh.read()
    print(f"dp (a) groups the entry point opened (opened, backend, world): {groups}; "
          f"logged data=sharded: {sharded}", flush=True)
    if groups != [(True, "nccl", 1)] * 3 or not sharded:
        fail(f"dp (a): groups {groups}, data=sharded logged {sharded}")
    return [train_launches, predict_launches]


def dp_commands(tmp):
    """(b)'s commands, each run by both ranks: butd device, semantic sharded,
    butd preempted at step 4, resumed."""
    outs = {k: os.path.join(tmp, k) for k in ("butd", "semantic", "preempted")}
    butd = entry_argv("implicit", outs["butd"], *DP_FLAGS, "--data_mode", "device")
    pre = entry_argv("implicit", outs["preempted"], *DP_FLAGS, "--data_mode", "device")
    return outs, [
        {"argv": butd, "kernel": "B1"},
        {"argv": entry_argv("semantic", outs["semantic"], *DP_FLAGS, "--data_mode", "sharded"),
         "kernel": "B2"},
        {"argv": pre, "env": {"REGAT_FAULT_PREEMPT_STEP": "4"}, "kernel": "B1"},
        {"argv": pre + ["--resume"], "kernel": "B1"},
    ]


def dp_child(spec_path, rank):
    """One rank of (b): open the gloo group, then run each command through
    `main.main`, recording its launches, forward passes, step times and
    final parameters, and last the all-reduce of the step's buffer alone."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.train.step import EvalSteps, TrainSteps, real_batches

    with open(spec_path) as fh:
        spec = json.load(fh)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                            world_size=2, rank=rank)
    real_step, real_block, real_batch = TrainSteps.step, EvalSteps.block, EvalSteps.batch
    real_run = port_main.run_training
    records, flat_numel = [], [0]
    for i, cmd in enumerate(spec["commands"]):
        os.environ.pop("REGAT_FAULT_PREEMPT_STEP", None)
        os.environ.update(cmd.get("env", {}))
        rec = {"steps": [], "eval_passes": 0}

        def step(self, R, inputs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            graphs = len(self.graphs.capture_seconds())
            ev[0].record()
            m = real_step(self, R, inputs)
            ev[1].record()
            rec["steps"].append((ev, len(self.graphs.capture_seconds()) > graphs))
            flat_numel[0] = self.sums.flat.numel()
            return m

        def block(self, R, blk):
            rec["eval_passes"] += real_batches(blk)
            return real_block(self, R, blk)

        def batch(self, b):
            rec["eval_passes"] += 1
            return real_batch(self, b)

        def run(*a, **k):
            model, best = real_run(*a, **k)
            np.savez(os.path.join(spec["out"], f"params-{i}-rank{rank}.npz"),
                     **{n: p.detach().cpu().numpy() for n, p in model.named_parameters()})
            return model, best

        TrainSteps.step, EvalSteps.block, EvalSteps.batch = step, block, batch
        port_main.run_training = run
        reset_counts()
        t0 = time.perf_counter()
        result = port_main.main(cmd["argv"])
        torch.cuda.synchronize()
        steps = rec.pop("steps")
        rec.update(wall_s=time.perf_counter() - t0, launches=counts(),
                   backward=backward_launches("b1"), preempted=result is None,
                   train_steps=len(steps),
                   step_ms=[a.elapsed_time(b) for (a, b), cap in steps if not cap])
        records.append(rec)
    flat = torch.zeros(flat_numel[0], device="cuda")
    reduce_ms = allreduce_ms(flat)
    dist.destroy_process_group()
    with open(os.path.join(spec["out"], f"child-rank{rank}.json"), "w") as fh:
        json.dump({"records": records, "allreduce_ms": reduce_ms,
                   "allreduce_bytes": flat_numel[0] * 4}, fh)


def run_dp_children(tmp, commands, timeout=600, child="--dp_child", label="dp (b)"):
    """Both ranks of 23 (b) (or of 24, `child` --tp_child) as child
    processes of this script (stopped on any failure) -> each rank's
    report."""
    os.makedirs(tmp, exist_ok=True)
    spec = os.path.join(tmp, "child_spec.json")
    with open(spec, "w") as fh:
        json.dump({"port": free_port(), "out": tmp, "commands": commands}, fh)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("REGAT_", "MASTER_"))}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), child, spec,
                               str(r)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(os.path.join(tmp, f"child-rank{r}.log"), "w") as fh:
            fh.write(log)
        if p.returncode != 0:
            fail(f"{label} rank {r} exited {p.returncode}:\n{log[-4000:]}")
    reports = []
    for r in (0, 1):
        with open(os.path.join(tmp, f"child-rank{r}.json")) as fh:
            reports.append(json.load(fh))
    return reports


def dp_reference(argv, device):
    """(b)'s butd run computed by its two ranks' functions in this process,
    eagerly: per step each rank's gradient sums of its 128 rows
    (`grad_sums`), the two buffers added (the all-reduce's one addition),
    the update applied to each (`apply_sums`) -> rank 0's final parameters."""
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
    from tf_vqa_regat_tpu_torch.parallel.mesh import batch_slice
    from tf_vqa_regat_tpu_torch.train import step as tstep
    from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule

    cfg = port_main.parse(argv)[0]
    ds = port_main.build_dataset(cfg, "train")
    store, R = DeviceStore(ds, device), cfg.resolved_num_rois()
    ranks = []
    for _ in range(2):
        model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device)
        opt = Adamax(model, trainable_mask(model, False), make_lr_schedule(
            cfg.base_lr, DP_STEPS, cfg.lr_decay_rate, cfg.lr_decay_step), cfg.grad_clip)
        ranks.append((model, opt, tstep.FlatSums(opt.params, device)))
    for idx in store.epoch_indices(0, cfg.batch_size, True, cfg.seed):
        for r, (model, opt, sums) in enumerate(ranks):
            rows = torch.from_numpy(batch_slice(idx, r, 2)).to(device)
            sums.write(*tstep.grad_sums(model, opt.params, gather_batch(store, rows, R),
                                        opt.count, cfg.seed, cfg.grad_accum, rank=r))
        total = ranks[0][2].flat + ranks[1][2].flat
        for model, opt, sums in ranks:
            sums.flat.copy_(total)
            tstep.apply_sums(opt, sums)
    return {n: p.detach().cpu().numpy() for n, p in ranks[0][0].named_parameters()}


def check_dp_gloo(tmp, smi):
    """(b): two ranks on the one card over gloo (module docstring). Returns
    every rank's launches of every run."""
    import numpy as np
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.data.sharded_store import sharded_layout

    outs, commands = dp_commands(tmp)
    t0 = time.perf_counter()
    reports = run_dp_children(tmp, commands)
    wall = time.perf_counter() - t0
    # (a'): (b)'s butd flags at world 1, no group, in this process
    solo_out = DP_SOLO["implicit"] = os.path.join(tmp, "solo")
    reset_counts()
    port_main.main(entry_argv("implicit", solo_out, *DP_FLAGS, "--data_mode", "device"))
    solo_launches = read_path_counts()
    launches = [solo_launches]
    # the train steps of each run: butd, semantic sharded (the larger
    # shard's entries over 128 a rank), preempted at step 4, resumed
    cfg = port_main.parse(commands[1]["argv"])[0]
    max_entries = sharded_layout(port_main.build_dataset(cfg, "train"), 2)[2]
    run_steps = (DP_STEPS, -(-max_entries // (cfg.batch_size // 2)), 4, DP_STEPS - 4)
    for i, cmd in enumerate(commands):
        for r, rep in enumerate(reports):
            rec = rep["records"][i]
            family = "implicit" if cmd["kernel"] == "B1" else "semantic"
            want = expected_launches(family, rec["eval_passes"], rec["train_steps"])
            print(f"dp (b) run {i} rank {r}: {rec['train_steps']} steps, {rec['eval_passes']} "
                  f"eval passes, launches {json.dumps(rec['launches'])}, preempted "
                  f"{rec['preempted']}, {rec['wall_s']:.1f} s wall", flush=True)
            if rec["launches"] != want or rec["train_steps"] != run_steps[i]:
                fail(f"dp (b) run {i} rank {r}: {rec['train_steps']} steps, launches "
                     f"{rec['launches']}, want {want}")
            if rec["preempted"] != (i == 2):
                fail(f"dp (b) run {i} rank {r}: preempted {rec['preempted']}")
            launches.append(rank_launches(rec, f"dp (b) run {i} rank {r}"))
    # the ranks' parameters bit-identical; (b) against (a')
    for i in (0, 1, 3):
        ranks = [np.load(os.path.join(tmp, f"params-{i}-rank{r}.npz")) for r in (0, 1)]
        same = all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0].files)
        if not same:
            fail(f"dp (b) command {i}: the ranks' parameters differ")
    two, one = read_run(outs["butd"]), read_run(solo_out)
    gaps = {f"{k}@{e}": abs(two[1][e][k] - one[1][e][k]) / max(abs(one[1][e][k]), 1e-30)
            for e in one[1] for k in ("train_loss", "train_score", "eval_score", "eval_loss")}
    metric = max(gaps.values())
    beyond = sum(int((np.abs(two[0][k] - one[0][k]) > DP_PARAM_ATOL
                      + DP_PARAM_RTOL * np.abs(one[0][k])).sum()) for k in one[0])
    total = sum(v.size for v in one[0].values())
    diff = max(float(np.abs(two[0][k] - one[0][k]).max()) for k in one[0])
    resumed = run_distance(two, read_run(outs["preempted"]))
    with np.load(os.path.join(tmp, "params-0-rank0.npz")) as z:
        ranked = {k: z[k] for k in z.files}
    ref = dp_reference(commands[0]["argv"], torch.device("cuda", 0))
    ref_diff = max(float(np.abs(ranked[k] - v).max()) for k, v in ref.items())
    ref_excess = max(float((np.abs(ranked[k] - v) - RESUME_ATOL - RESUME_RTOL * np.abs(v)).max())
                     for k, v in ref.items())
    ref_bits = all(np.array_equal(ranked[k], v) for k, v in ref.items())
    step_ms = statistics.median(reports[0]["records"][0]["step_ms"])
    print(f"dp (b) 2 ranks over gloo on one card vs (a') 1 rank: metrics max rel diff {metric} "
          f"(bound {DP_METRIC_RTOL}; each {json.dumps(gaps)}); params max abs diff {diff}, {beyond} of {total} elements "
          f"beyond JAX's dp tolerance (rtol {DP_PARAM_RTOL}, atol {DP_PARAM_ATOL}; not held); "
          f"vs the two ranks' reduced step in one process (eager): params max abs diff "
          f"{ref_diff}, excess {ref_excess}, bit-equal {ref_bits}; "
          f"preempted at step 4 and resumed vs uninterrupted: params max abs diff "
          f"{resumed[0]}, excess {resumed[1]}, metrics {resumed[2]}, bit-equal {resumed[3]}; "
          f"butd step (128 a rank) median {step_ms:.3f} ms (CUDA events, graphs and the gloo "
          f"all-reduce staged through the host, two ranks sharing one card); the gloo "
          f"all-reduce of {reports[0]['allreduce_bytes']} bytes alone "
          f"{reports[0]['allreduce_ms']:.3f} ms (host clock, staged through the host, not an "
          f"NVLink or NCCL number); children {wall:.1f} s wall; on {smi}", flush=True)
    if not metric <= DP_METRIC_RTOL:
        fail(f"dp (b): 2 ranks' metrics differ from 1 rank's by rel {metric}")
    if not resumed[1] <= 0.0 or not resumed[2] <= RESUME_RTOL:
        fail(f"dp (b): the resumed run differs from the uninterrupted one: {resumed}")
    if not ref_excess <= 0.0:
        fail(f"dp (b): the 2-rank run differs from its ranks computed in one process by "
             f"{ref_diff} (excess {ref_excess})")
    for k in outs.values():
        shutil.rmtree(os.path.join(k, "checkpoints"), ignore_errors=True)
    return launches, {"step_ms_gloo": step_ms, "allreduce_ms_gloo": reports[0]["allreduce_ms"]}


def run_phase_23(tmp_root, smi, device):
    """Phase 23, (a) and (b); returns the launches of their paths."""
    import torch

    with phase("23 (a), one rank over NCCL"):
        launches = check_dp_nccl(os.path.join(tmp_root, "dp_nccl"), smi, device)
        dp_step_times(device, smi)
    torch.cuda.empty_cache()
    with phase("23 (b), two ranks over gloo on one card"):
        launches += check_dp_gloo(os.path.join(tmp_root, "dp_gloo"), smi)[0]
    torch.cuda.empty_cache()
    return launches


# phase 24: tensor parallelism, serve over the sharded store, the sharded
# ensemble. (a) runs 23 (b)'s flags (butd's and semantic's full widths,
# b = 256, 6 steps in blocks of 2, dropout off) at --tp_size 2 on two gloo
# ranks sharing the card; the tp = 1 runs it is held to are 23 (b)'s (a')
# for butd (DP_SOLO) and one in this process for semantic.
TP_FLAGS = DP_FLAGS
# 24 (a): the same run at tp = 2 against tp = 1: the same gradients summed
# in another order (the split matmuls, the norms of the split kernels), as
# phase 7 holds one step's loss summed in another order (LOSS_RTOL): the
# train loss, and --mode eval of one .npz at both tp. The end-of-epoch eval
# loss of the two runs is printed, not held: it reads weights that Adamax
# moved apart (its first steps move an element by about lr times the sign
# of its gradient, which the order of the sums sets for tiny gradients; on
# an H100 the eval loss read 1.13e-4 apart after 6 steps, with 12,108 of
# 22.7 M parameters beyond JAX's tolerance); so is JAX's tensor-parallel
# parameter tolerance (tests/test_parallel.py), as in 23 (b)
TP_METRIC_RTOL = LOSS_RTOL
# 24 (b): served logits on the sharded store against the replicated store
# (the same rows, gathered and summed over the ranks, then the same graph)
SERVE_SHARDED_ATOL = 1e-5
# the run's directories: 23 (b)'s (a') at one rank, by family
DP_SOLO = {}


def tp_commands(tmp, serve_npz, serve_budget, ensemble_spec):
    """24's child commands, each run by both ranks: per family (butd,
    semantic) train at tp = 2, then eval and predict of the written .npz at
    tp = 2; butd at tp = 2 preempted at step 4; the serve engine over the
    sharded store at dp = 2; the sharded ensemble at dp = 2; the gloo
    collectives of the TP step alone."""
    outs = {k: os.path.join(tmp, k) for k in
            ("implicit", "semantic", "preempted", "ensemble")}
    cmds = []
    for family in ("implicit", "semantic"):
        final = os.path.join(outs[family], f"{family}-butd-pretrained_model.npz")
        infer = entry_argv(family, outs[family], "--synthetic_val_size", "256", "--tp_size", "2",
                           "--checkpoint", final)
        cmds += [{"kind": "main", "family": family, "run": "train",
                  "argv": entry_argv(family, outs[family], *TP_FLAGS, "--tp_size", "2",
                                     "--data_mode", "device")},
                 {"kind": "main", "family": family, "run": "eval",
                  "argv": infer + ["--mode", "eval"]},
                 {"kind": "main", "family": family, "run": "predict", "passes": -(-256 // 64),
                  "argv": infer + ["--mode", "predict", "--predict_split", "val"]}]
    cmds.append({"kind": "main", "family": "implicit", "run": "preempted",
                 "argv": entry_argv("implicit", outs["preempted"], *TP_FLAGS, "--tp_size", "2",
                                    "--data_mode", "device"),
                 "env": {"REGAT_FAULT_PREEMPT_STEP": "4"}})
    cmds.append({"kind": "serve", "family": "implicit", "run": "serve",
                 "argv": entry_argv("implicit", tmp, "--mode", "serve", "--checkpoint",
                                    serve_npz, "--device_store_budget_gb", repr(serve_budget))})
    cmds.append({"kind": "ensemble", "family": "ensemble", "run": "ensemble",
                 "argv": entry_argv("semantic", outs["ensemble"], "--mode", "ensemble_eval",
                                    "--ensemble_checkpoints", ensemble_spec,
                                    "--data_mode", "sharded")})
    cmds.append({"kind": "collectives", "family": None, "run": "collectives"})
    return outs, cmds


SERVE_QUESTIONS = ["what color is the car ?", "how many people are on the left ?",
                   "is the man on the dog ?", "what is the woman in ?"]


def serve_requests(engine, n=40):
    """n (question, image id) requests over the engine's images."""
    ids = sorted(engine.img_index)
    return ([SERVE_QUESTIONS[i % 4] for i in range(n)], [ids[(7 * i) % len(ids)]
                                                        for i in range(n)])


def serve_batch(engine, B=8):
    """One request batch as tensors on the engine's card: token ids, image
    indices and validity (the last slot invalid)."""
    import torch

    qs, ids = serve_requests(engine, B)
    dev = engine.device
    toks = torch.tensor([engine._encode(q) for q in qs], device=dev)
    img = torch.tensor([engine.img_index[i] for i in ids], device=dev)
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    valid[-1] = False
    return toks, img, valid


def tp_child(spec_path, rank):
    """One rank of 24: open the gloo group, then run each command (a
    barrier before each), recording its launches (counts set to 0 just
    before it), the heads of every B1 and B2 launch, forward passes, step
    times and final parameters; last the gloo collectives of the TP step
    alone."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga
    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia
    from tf_vqa_regat_tpu_torch.parallel import distributed
    from tf_vqa_regat_tpu_torch.serve import InferenceEngine
    from tf_vqa_regat_tpu_torch.train import ensemble
    from tf_vqa_regat_tpu_torch.train.step import EvalSteps, TrainSteps, real_batches

    with open(spec_path) as fh:
        spec = json.load(fh)
    out = spec["out"]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                            world_size=2, rank=rank)
    device = torch.device("cuda", 0)
    heads = set()
    for kernel in (ia._Kernel, ga._Kernel):
        def spy(self, q, *a, real=kernel.__call__, **k):
            heads.add(int(q.shape[2]))
            return real(self, q, *a, **k)
        kernel.__call__ = spy
    real_step, real_block, real_batch = TrainSteps.step, EvalSteps.block, EvalSteps.batch
    real_run, real_passes = port_main.run_training, ensemble._sharded_passes
    records, coll = [], {}
    for i, cmd in enumerate(spec["commands"]):
        os.environ.pop("REGAT_FAULT_PREEMPT_STEP", None)
        os.environ.update(cmd.get("env", {}))
        rec = {"steps": [], "eval_passes": 0, "run": cmd["run"]}

        def step(self, R, inputs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            m = real_step(self, R, inputs)
            ev[1].record()
            rec["steps"].append(ev)
            return m

        def block(self, R, blk):
            rec["eval_passes"] += real_batches(blk)
            return real_block(self, R, blk)

        def batch(self, b):
            rec["eval_passes"] += 1
            return real_batch(self, b)

        def run(*a, **k):
            model, best = real_run(*a, **k)
            np.savez(os.path.join(out, f"params-{i}-rank{rank}.npz"),
                     **{n: p.detach().cpu().numpy() for n, p in model.named_parameters()})
            return model, best

        probs, entries = [], []

        def passes(*a, **k):
            for p, b in real_passes(*a, **k):
                probs.append(p.cpu().numpy().copy())
                entries.append(np.asarray(b["entry"]))
                yield p, b

        TrainSteps.step, EvalSteps.block, EvalSteps.batch = step, block, batch
        port_main.run_training, ensemble._sharded_passes = run, passes
        distributed.barrier()
        heads.clear()
        reset_counts()
        t0 = time.perf_counter()
        if cmd["kind"] == "main":
            result = port_main.main(cmd["argv"])
            rec["result"] = result if isinstance(result, (str, float, type(None))) \
                else list(result)
        elif cmd["kind"] == "ensemble":
            rec["result"] = port_main.main(cmd["argv"])
            rec["eval_passes"] = len(probs)
            np.savez(os.path.join(out, f"ensemble-rank{rank}.npz"), probs=np.concatenate(probs),
                     entries=np.concatenate(entries))
        elif cmd["kind"] == "serve":
            cfg = port_main.parse(cmd["argv"])[0]
            ds = port_main.build_dataset(cfg)
            runs = [0]
            real_engine_run = InferenceEngine._run

            def counted(self, *a):
                runs[0] += 1
                return real_engine_run(self, *a)

            InferenceEngine._run = counted
            try:
                engine = InferenceEngine(cfg, ds, port_main.load_model(cfg, ds), device,
                                         batch_sizes=(1, 8, 32))
                logits = engine.logits(*serve_batch(engine))
                np.save(os.path.join(out, f"serve-logits-rank{rank}.npy"), logits.cpu().numpy())
                if rank == 0:
                    rec["result"] = engine.infer(*serve_requests(engine))
                    engine.stop()
                else:
                    engine.follow()
            finally:
                InferenceEngine._run = real_engine_run
            rec["store_mode"], rec["eval_passes"] = engine.store_mode, runs[0] + 1
        else:  # the TP step's gloo collectives alone, at butd's b = 256 sizes
            half = torch.randn(256, 100, 8, 64, device=device)
            roi = torch.randn(256, 100, 1024, device=device)
            for name, fn in (("all_gather_q_ms", lambda: distributed.all_gather(half, 2)),
                             ("all_reduce_roi_ms", lambda: distributed.all_reduce_([roi]))):
                times = []
                for _ in range(8):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t1) * 1e3)
                coll[name] = statistics.median(times[2:])
            coll["bytes_q_part"], coll["bytes_roi"] = half.numel() * 4, roi.numel() * 4
        torch.cuda.synchronize()
        steps = rec.pop("steps")
        rec.update(wall_s=time.perf_counter() - t0, launches=counts(),
                   backward=backward_launches("b1"), heads=sorted(heads),
                   train_steps=len(steps), step_ms=[a.elapsed_time(b) for a, b in steps])
        records.append(rec)
    distributed.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out, f"child-rank{rank}.json"), "w") as fh:
        json.dump({"records": records, "collectives": coll}, fh)


def same_answers(a, b):
    """Two engines' answers: the same answers (or errors), confidences
    within SERVE_SHARDED_ATOL."""
    return len(a) == len(b) and all(
        x.keys() == y.keys() and x.get("answer") == y.get("answer") and x.get("error") ==
        y.get("error") and abs(x.get("confidence", 0.0) - y.get("confidence", 0.0))
        <= SERVE_SHARDED_ATOL for x, y in zip(a, b))


def assembled(ranks):
    """Full parameters from the two ranks' parts (model index = rank at
    dp = 1); the replicated leaves must be bit-identical across the ranks."""
    import numpy as np

    from tf_vqa_regat_tpu_torch.parallel.mesh import shard_axis

    full = {}
    for k in ranks[0]:
        axis = shard_axis(k)
        if axis is None:
            if not np.array_equal(ranks[0][k], ranks[1][k]):
                fail(f"tp (a): replicated leaf {k} differs between the ranks")
            full[k.replace(".", "/")] = ranks[0][k]
        else:
            full[k.replace(".", "/")] = np.concatenate([ranks[0][k], ranks[1][k]], axis=axis)
    return full


def answer_gaps(cfg_argv, npz_path, entries, device):
    """The top-two logit gap, relative to the largest |logit|, of each entry
    of the val split under the model of `npz_path` at tp = 1."""
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.data.store import gather_batch
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT
    from tf_vqa_regat_tpu_torch.params import load_jax_arrays, load_npz
    from tf_vqa_regat_tpu_torch.train.loop import build_store

    if not len(entries):
        return []
    cfg = port_main.parse(cfg_argv)[0]
    ds = port_main.build_dataset(cfg)
    model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device).eval()
    load_jax_arrays(model, load_npz(npz_path))
    batch = gather_batch(build_store(cfg, ds, device, warn=False),
                         torch.tensor(entries, device=device), cfg.resolved_num_rois())
    with torch.no_grad():
        logits = model(batch)
    top2 = logits.topk(2, dim=-1).values
    return ((top2[:, 0] - top2[:, 1]) / logits.abs().max()).tolist()


def control_child(out, kind):
    """Phase 24's controls: butd at tp = 1 with TP_FLAGS (as 23 (b)'s (a'))
    where only the order of some sums changes, by a monkeypatch here. `fc2`:
    the classifier's fc2 product as the sum of its two halves over the input
    dimension, as tp = 2 sums it. `tp2`: every sum that tp = 2 splits, split
    the same way in one process: the norms of the split kernels (Q, K, the
    grouped V kernel, the classifier's two layers) as the sum of their two
    halves' sums of squares, Q, K and V·W computed per half of the heads
    and joined, the classifier's hidden layer per half of its columns, fc2
    as in `fc2`."""
    sys.path.insert(0, REPO)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.models import regat
    from tf_vqa_regat_tpu_torch.models.classifier import Classifier
    from tf_vqa_regat_tpu_torch.nn import dropout
    from tf_vqa_regat_tpu_torch.ops import graph_attention, weight_norm

    def fc2_halves(self, x, generator=None):
        x = dropout(torch.relu(self.fc1(x)), self.drop_rate, self.training, generator)
        k = self.fc2.kernel()
        h = k.shape[0] // 2
        return (x[:, :h] @ k[:h] + x[:, h:] @ k[h:]) + self.fc2.b

    Classifier.forward = fc2_halves
    if kind == "tp2":
        def scale(v, g, axis):
            a, b = v.split(v.shape[axis] // 2, dim=axis)
            return g * torch.rsqrt((torch.sum(a * a) + torch.sum(b * b)) + 1e-12)

        def cols_forward(self, x, out_dtype=None):
            k = self.v * scale(self.v, self.g, 1)
            h = k.shape[1] // 2
            return torch.cat([x @ k[:, :h], x @ k[:, h:]], -1) + self.b

        class Einsum:
            """The module's torch, the grouped projection per half of the heads."""

            def __getattr__(self, name):
                return getattr(torch, name)

            @staticmethod
            def einsum(eq, x, k):
                if eq != "bnd,hdo->bnho":
                    return torch.einsum(eq, x, k)
                h = k.shape[0] // 2
                return torch.cat([torch.einsum(eq, x, k[:h]), torch.einsum(eq, x, k[h:])], 2)

        real_init, real_forward = regat.ReGAT.__init__, weight_norm.WNLinear.forward
        real_kernel = weight_norm.WNLinear.kernel

        def init(self, *a, **k):
            real_init(self, *a, **k)
            for d in self.v_relation.gatt.neighbor:
                d.query.layers[0].emul = d.key.layers[0].emul = "cols"
            self.classifier.fc1.emul, self.classifier.fc2.emul = "cols", "rows"

        def forward(self, x, out_dtype=None):
            if getattr(self, "emul", None) == "cols":
                return cols_forward(self, x, out_dtype)
            return real_forward(self, x, out_dtype)

        def kernel(self, dtype=torch.float32):
            axis = {"cols": 1, "rows": 0}.get(getattr(self, "emul", None))
            if axis is None:
                return real_kernel(self, dtype)
            return (self.v * scale(self.v, self.g, axis)).to(dtype)

        regat.ReGAT.__init__ = init
        weight_norm.WNLinear.forward, weight_norm.WNLinear.kernel = forward, kernel
        graph_attention.GroupedProjection.kernel = lambda self: self.v * scale(self.v, self.g, 0)
        graph_attention.torch = Einsum()
    port_main.main(entry_argv("implicit", out, *TP_FLAGS, "--data_mode", "device"))


def beyond_by_leaf(got, want, top=6):
    """The leaves with the most elements beyond JAX's tp tolerance, most
    first: [(leaf, count, its size)]."""
    import numpy as np

    counts = [(k, int((np.abs(got[k] - w) > DP_PARAM_ATOL + DP_PARAM_RTOL * np.abs(w)).sum()),
               int(w.size)) for k, w in want.items()]
    return sorted((c for c in counts if c[1]), key=lambda c: -c[1])[:top]


def check_tp(tmp, smi, device, npz):
    """24 (a)-(c) over the two gloo ranks, and (b) at one NCCL rank. Returns
    the launches of every path, each rank's apart."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.data.sharded_store import estimate_sharded_nbytes
    from tf_vqa_regat_tpu_torch.data.store import DeviceStore, estimate_nbytes
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT
    from tf_vqa_regat_tpu_torch.params import save_npz
    from tf_vqa_regat_tpu_torch.parallel.mesh import make_mesh
    from tf_vqa_regat_tpu_torch.serve import InferenceEngine
    from tf_vqa_regat_tpu_torch.train.ensemble import (
        averaged_probs,
        load_members,
        member_adj_tables,
    )
    from tf_vqa_regat_tpu_torch.train.logging import Logger
    from tf_vqa_regat_tpu_torch.train.loss import vqa_score_sum

    os.makedirs(tmp, exist_ok=True)
    launches = []
    # what 8 and 13 trained, or (run alone) the seed's models
    serve_npz = npz.get("implicit")
    if serve_npz is None:
        cfg = full_width_config("implicit", ["--mode", "serve"])
        ds = port_main.build_dataset(cfg)
        serve_npz = os.path.join(tmp, "serve.npz")
        save_npz(serve_npz, ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans))
    spec = LAST_ENSEMBLE.get("spec")
    if spec is None:
        parts = []
        for rt in ("implicit", "spatial", "semantic"):
            cfg = full_width_config("semantic", ["--relation_type", rt, "--mode", "ensemble_eval",
                                                 "--ensemble_checkpoints", "semantic:x"])
            ds = port_main.build_dataset(cfg)
            path = os.path.join(tmp, f"member-{rt}.npz")
            save_npz(path, ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans))
            parts.append(f"{rt}:{path}")
        spec = ",".join(parts)
    serve_argv = entry_argv("implicit", tmp, "--mode", "serve", "--checkpoint", serve_npz)
    cfg = port_main.parse(serve_argv)[0]
    ds = port_main.build_dataset(cfg)
    need, shard = estimate_nbytes(ds, False, "float32"), estimate_sharded_nbytes(
        ds, False, "float32", 2)
    budget = (need + shard) / 2 / 1e9  # only a shard of 2 fits

    # (b) at one NCCL rank: the sharded store (at one rank its estimate is
    # the replicated one's, so no budget chooses it: the policy is replaced
    # here), graphed, against the replicated engine
    from tf_vqa_regat_tpu_torch import serve

    model = port_main.load_model(cfg, ds)
    real_policy = serve.serve_store_mode
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        engines, served, logits, lat = {}, {}, {}, {}
        for mode in ("replicated", "sharded"):
            reset_counts()  # the serve path starts here
            runs = [0]
            real_run = InferenceEngine._run

            def counted(self, *a):
                runs[0] += 1
                return real_run(self, *a)

            InferenceEngine._run = counted
            serve.serve_store_mode = lambda *a, mode=mode: mode
            try:
                engines[mode] = engine = InferenceEngine(cfg, ds, model, device, (1, 8, 32),
                                                         mesh=make_mesh(0, 1))
                logits[mode] = engine.logits(*serve_batch(engine))
                served[mode] = engine.infer(*serve_requests(engine))
                passes = runs[0] + 1
            finally:
                InferenceEngine._run = real_run
                serve.serve_store_mode = real_policy
            path_launches = read_path_counts()
            launches.append(path_launches)
            if path_launches != expected_launches("implicit", passes):
                fail(f"serve (b) {mode}: launches {path_launches} for {passes} passes")
            if not engine.graphs.graphed or len(engine.graphs.capture_seconds()) != 3:
                fail(f"serve (b) {mode}: not graphed per batch size")
            for B in (1, 32):
                qs, ids = serve_requests(engine, B)
                times = []
                for _ in range(23):
                    t0 = time.perf_counter()
                    engine.infer(qs, ids)
                    times.append((time.perf_counter() - t0) * 1e3)
                lat[(mode, B)] = statistics.median(times[3:])
        gap = (logits["sharded"] - logits["replicated"]).abs().max().item()
    finally:
        dist.destroy_process_group()
    same = same_answers(served["sharded"], served["replicated"])
    print(f"serve (b) one NCCL rank, butd_vqa.json at full width, {json.dumps(served['sharded'][:3])}"
          f"...: sharded vs replicated store answers equal {same}, logits max abs diff {gap} "
          f"(bound {SERVE_SHARDED_ATOL}); engine.infer median (host clock, 20 calls) on {smi}: "
          f"b=1 {lat[('sharded', 1)]:.3f} ms sharded, {lat[('replicated', 1)]:.3f} ms replicated; "
          f"b=32 {lat[('sharded', 32)]:.3f} ms sharded ({32e3 / lat[('sharded', 32)]:.1f} "
          f"questions/s), {lat[('replicated', 32)]:.3f} ms replicated "
          f"({32e3 / lat[('replicated', 32)]:.1f} questions/s); graph captures "
          f"{json.dumps({str(k): v for k, v in engines['sharded'].graphs.capture_seconds().items()})} s",
          flush=True)
    if not same or not gap <= SERVE_SHARDED_ATOL:
        fail("serve (b): the sharded store's answers differ from the replicated store's")
    replicated_answers, replicated_logits = served["replicated"], logits["replicated"].cpu().numpy()
    del engines, model
    torch.cuda.empty_cache()

    # (a)-(c) on two gloo ranks
    outs, commands = tp_commands(tmp, serve_npz, budget, spec)
    t0 = time.perf_counter()
    reports = run_dp_children(tmp, commands, child="--tp_child", label="tp")
    wall = time.perf_counter() - t0
    by_run = {cmd["run"]: i for i, cmd in enumerate(commands)}
    eval_passes = -(-256 // 64)
    for i, cmd in enumerate(commands):
        if cmd["kind"] == "collectives":
            continue
        for r, rep in enumerate(reports):
            rec = rep["records"][i]
            steps = rec["train_steps"]
            # predict's passes are not eval steps: 256 questions at 64
            rec["eval_passes"] = cmd.get("passes", rec["eval_passes"])
            family = cmd["family"]
            if family == "ensemble":
                want = {"B1 eval": 2 * rec["eval_passes"], "B1 train": 0,
                        "B2": 4 * rec["eval_passes"], "B2 per-head": 0}
            else:
                want = expected_launches(family, rec["eval_passes"], steps)
            print(f"tp run {cmd['run']} {family} rank {r}: {steps} steps, {rec['eval_passes']} "
                  f"forward passes, launches {json.dumps(rec['launches'])} on heads "
                  f"{rec['heads']}, {rec['wall_s']:.1f} s wall", flush=True)
            if rec["launches"] != want or rec["heads"] != [16] \
                    or not any(rec["launches"].values()):
                fail(f"tp run {cmd['run']} rank {r}: launches {rec['launches']} on heads "
                     f"{rec['heads']}, want {want} on all 16")
            launches.append(rank_launches(rec, f"tp run {cmd['run']} rank {r}"))

    # (a): tp = 2 against tp = 1 per family
    if "implicit" not in DP_SOLO:
        DP_SOLO["implicit"] = os.path.join(tmp, "solo-implicit")
        port_main.main(entry_argv("implicit", DP_SOLO["implicit"], *TP_FLAGS,
                                  "--data_mode", "device"))
    reset_counts()
    DP_SOLO["semantic"] = os.path.join(tmp, "solo-semantic")
    port_main.main(entry_argv("semantic", DP_SOLO["semantic"], *TP_FLAGS, "--data_mode", "device"))
    launches.append(read_path_counts())
    end_gap = {}  # per family: (end-of-epoch eval loss rel gap, parameters beyond tolerance)
    for family in ("implicit", "semantic"):
        name = f"{family}-butd"
        two, one = read_run(outs[family], name), read_run(DP_SOLO[family], name)
        i = [j for j, c in enumerate(commands) if c["run"] == "train" and c["family"] == family][0]
        ranks = []
        for r in (0, 1):
            with np.load(os.path.join(tmp, f"params-{i}-rank{r}.npz")) as z:
                ranks.append({k: z[k] for k in z.files})
        full = assembled(ranks)
        if any(not np.array_equal(full[k], two[0][k]) for k in two[0]):
            fail(f"tp (a) {family}: the written .npz is not the ranks' parts put together")
        gaps = {f"{k}@{e}": abs(two[1][e][k] - one[1][e][k]) / max(abs(one[1][e][k]), 1e-30)
                for e in one[1] for k in ("train_loss", "train_score", "eval_score", "eval_loss")}
        # held: the steps' own loss; the end-of-epoch eval reads weights that
        # 6 Adamax steps moved apart (printed, as the parameters are)
        metric = max(v for k, v in gaps.items() if k.startswith("train_loss"))
        beyond = sum(int((np.abs(two[0][k] - one[0][k]) > DP_PARAM_ATOL
                          + DP_PARAM_RTOL * np.abs(one[0][k])).sum()) for k in one[0])
        total = sum(v.size for v in one[0].values())
        diff = max(float(np.abs(two[0][k] - one[0][k]).max()) for k in one[0])
        end_gap[family] = (max(v for k, v in gaps.items() if k.startswith("eval_loss")), beyond)
        step_ms = statistics.median(reports[0]["records"][i]["step_ms"])
        # eval and predict of the tp = 2 .npz at tp = 1, in this process
        final = os.path.join(outs[family], f"{name}-pretrained_model.npz")
        infer = entry_argv(family, os.path.join(tmp, f"infer1-{family}"), "--synthetic_val_size",
                           "256", "--checkpoint", final)
        score1, loss1 = port_main.main(infer + ["--mode", "eval"])
        pred1 = port_main.main(infer + ["--mode", "predict", "--predict_split", "val"])
        score2, loss2 = reports[0]["records"][i + 1]["result"]
        pred2 = reports[0]["records"][i + 2]["result"]
        with open(pred1) as fh, open(pred2) as gh:
            a1, a2 = json.load(fh), json.load(gh)
        qids = [a["question_id"] for a in a1]
        differ = [j for j, (x, y) in enumerate(zip(a1, a2)) if x != y]
        gaps_at = answer_gaps(infer + ["--mode", "eval"], final, differ, device)
        eval_rel = abs(loss2 - loss1) / abs(loss1)
        print(f"tp (a) {family} at tp=2 (two gloo ranks on one card) vs tp=1 (one process): "
              f"train loss max rel diff {metric} (bound {TP_METRIC_RTOL}; each metric, the "
              f"end-of-epoch eval of weights 6 steps apart not held: {json.dumps(gaps)}); "
              f"params max abs diff {diff}, {beyond} of {total} elements beyond JAX's tp "
              f"tolerance (rtol {DP_PARAM_RTOL}, atol {DP_PARAM_ATOL}; not held); replicated "
              f"leaves bit-identical on the two ranks; --mode eval of the tp=2 .npz: score "
              f"{score2} vs {score1}, loss {loss2} vs {loss1} (rel {eval_rel}); --mode predict: "
              f"{len(differ)} of {len(qids)} answers differ (top-two gaps {gaps_at}); the eager "
              f"TP train step median {step_ms:.3f} ms (CUDA events, 6 steps, the gloo "
              f"collectives staged through the host, two ranks sharing one card) on {smi}",
              flush=True)
        if not metric <= TP_METRIC_RTOL or not eval_rel <= TP_METRIC_RTOL:
            fail(f"tp (a) {family}: tp=2 differs from tp=1 by rel {metric} / {eval_rel}")
        if a1 and [a["question_id"] for a in a2] != qids or any(g > LOGITS_RTOL for g in gaps_at):
            fail(f"tp (a) {family}: answers differ outside ties: {differ} {gaps_at}")
    # the controls: tp = 1 runs that differ from plain tp = 1 only in the
    # order of sums (ROADMAP Queue C's open check), each in a child process
    one = read_run(DP_SOLO["implicit"])
    tp2 = read_run(outs["implicit"], "implicit-butd")
    print(f"tp (a) butd tp=2 vs tp=1: end-of-epoch eval loss rel gap "
          f"{end_gap['implicit'][0]}, {end_gap['implicit'][1]} parameters beyond JAX's tp "
          f"tolerance, most in {beyond_by_leaf(tp2[0], one[0])}; semantic tp=2: "
          f"{end_gap['semantic'][0]}, {end_gap['semantic'][1]}", flush=True)
    for kind in ("fc2", "tp2"):
        control = os.path.join(tmp, f"control-{kind}")
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--control_child",
                                control, kind], cwd=REPO, capture_output=True, text=True,
                               timeout=600)
        if child.returncode != 0:
            fail(f"tp control {kind} exited {child.returncode}:\n{child.stderr[-3000:]}")
        ctl = read_run(control)
        ctl_gap = max(abs(ctl[1][e]["eval_loss"] - m["eval_loss"]) / abs(m["eval_loss"])
                      for e, m in one[1].items())
        ctl_beyond = beyond_by_leaf(ctl[0], one[0], top=len(one[0]))
        ratio = end_gap["implicit"][0] / max(ctl_gap, 1e-30)
        to_tp2 = beyond_by_leaf(ctl[0], tp2[0], top=len(one[0]))
        print(f"tp (a) control {kind} vs tp=2: params max abs diff "
              f"{max(float(np.abs(ctl[0][k] - tp2[0][k]).max()) for k in one[0])}, "
              f"{sum(c[1] for c in to_tp2)} beyond JAX's tp tolerance", flush=True)
        print(f"tp (a) control {kind} (control_child), butd at tp=1 vs plain tp=1: "
              f"end-of-epoch eval loss rel gap {ctl_gap}, "
              f"{sum(c[1] for c in ctl_beyond)} parameters beyond JAX's tp tolerance, most in "
              f"{ctl_beyond[:6]}; tp=2's gap over this control's: {ratio:.3f} (a fault above "
              f"3, ROADMAP Queue C); train loss rel diff "
              f"{abs(ctl[1][0]['train_loss'] - one[1][0]['train_loss']) / abs(one[1][0]['train_loss'])}",
              flush=True)

    # a tp = 2 checkpoint resumed at tp = 1
    reset_counts()
    port_main.main(entry_argv("implicit", outs["preempted"], *TP_FLAGS, "--data_mode", "device",
                              "--resume"))
    launches.append(read_path_counts())
    got, want = read_run(outs["preempted"]), read_run(DP_SOLO["implicit"])
    resumed = run_distance(got, want)
    train_rel = max(abs(got[1][e]["train_loss"] - m["train_loss"]) / abs(m["train_loss"])
                    for e, m in want[1].items())
    coll = reports[0]["collectives"]
    print(f"tp (a) butd preempted at step 4 at tp=2, resumed at tp=1 vs tp=1 uninterrupted: "
          f"params max abs diff {resumed[0]}, train loss rel diff {train_rel} (bound "
          f"{TP_METRIC_RTOL}), every metric's largest {resumed[2]} (not held); gloo collectives of the b=256 TP step alone (host clock, staged "
          f"through the host, two ranks on one card, median of 6; not an NVLink or NCCL "
          f"number): all-gather of q ({coll['bytes_q_part']} bytes a rank) "
          f"{coll['all_gather_q_ms']:.3f} ms, all-reduce of the attention input's gradient "
          f"({coll['bytes_roi']} bytes) {coll['all_reduce_roi_ms']:.3f} ms; children "
          f"{wall:.1f} s wall", flush=True)
    if not train_rel <= TP_METRIC_RTOL:
        fail(f"tp (a): the tp=2 checkpoint resumed at tp=1 differs by rel {train_rel}")

    # (b) on two gloo ranks: the budget takes the sharded store
    i = by_run["serve"]
    rec = reports[0]["records"][i]
    two_logits = [np.load(os.path.join(tmp, f"serve-logits-rank{r}.npy")) for r in (0, 1)]
    gap = max(float(np.abs(x - replicated_logits).max()) for x in two_logits)
    same = same_answers(rec["result"], replicated_answers)
    print(f"serve (b) two gloo ranks at dp=2 (budget {budget:.6f} GB: {need} bytes "
          f"replicated, {shard} a shard): store {rec['store_mode']} on both "
          f"{[r['records'][i]['store_mode'] for r in reports]}; answers equal to the "
          f"replicated engine's {same}; logits max abs diff {gap}", flush=True)
    if {r["records"][i]["store_mode"] for r in reports} != {"sharded"} or not same \
            or not gap <= SERVE_SHARDED_ATOL:
        fail("serve (b) over two ranks: not sharded, or answers differ")

    # (c) the sharded ensemble against the replicated one, kernel path
    i = by_run["ensemble"]
    ecfg = port_main.parse(commands[i]["argv"])[0].replace(data_mode="device")
    eds = port_main.build_dataset(ecfg)
    members = load_members(ecfg, eds, device, Logger(os.path.join(tmp, "ensemble_log.txt")))
    store, tables = DeviceStore(eds, device), member_adj_tables(members, eds, device)
    want = np.zeros((len(eds.entries.question_ids), eds.num_ans), np.float32)
    # per entry: its targets' gap at the replicated top two (a tie's slack)
    tgap = np.zeros(len(want), np.float32)
    score_r, n = torch.zeros((), device=device), 0.0
    for idx in store.epoch_indices(0, ecfg.resolved_eval_batch(), False, ecfg.seed):
        p, batch = averaged_probs(members, store, torch.from_numpy(idx).to(device),
                                  ecfg.resolved_num_rois(), tables)
        ok = idx >= 0
        want[idx[ok]] = p.cpu().numpy()[ok]
        t = batch["target"].gather(1, p.topk(2, dim=-1).indices)
        tgap[idx[ok]] = (t[:, 0] - t[:, 1]).abs().cpu().numpy()[ok]
        score_r = score_r + vqa_score_sum(p, batch["target"], batch["valid"])
        n += float(batch["valid"].sum())
    score_r = 100.0 * float(score_r) / n
    del members, store, tables
    seen, diff, moved, slack = np.zeros(len(want), int), 0.0, 0, 0.0
    for r in (0, 1):
        with np.load(os.path.join(tmp, f"ensemble-rank{r}.npz")) as z:
            probs, entries = z["probs"], z["entries"]
        ok = entries >= 0
        seen[entries[ok]] += 1
        got, ref = probs[ok], want[entries[ok]]
        diff = max(diff, float(np.abs(got - ref).max()))
        top2 = np.sort(ref, axis=-1)[:, -2:]
        tied = (top2[:, 1] - top2[:, 0]) <= ENSEMBLE_PROB_ATOL
        moved += int(((got.argmax(-1) != ref.argmax(-1)) & ~tied).sum())
        slack += float(tgap[entries[ok]][tied].sum())
    scores = [rep["records"][i]["result"] for rep in reports]
    print(f"ensemble (c) {spec.split(',')} over the sharded store on two gloo ranks: scores "
          f"{scores} vs the replicated store's {score_r} (tie slack {100.0 * slack / n}); "
          f"averaged probabilities max abs diff "
          f"{diff} (bound {ENSEMBLE_PROB_ATOL}), {moved} answers differ outside ties; every "
          f"entry scored once {bool((seen == 1).all())}", flush=True)
    if not (seen == 1).all() or not diff <= ENSEMBLE_PROB_ATOL or moved \
            or any(abs(s - score_r) > 100.0 * slack / n + 1e-6 * score_r for s in scores):
        fail(f"ensemble (c): sharded {scores} vs replicated {score_r}, probs {diff}, "
             f"{moved} moved")
    for k in outs.values():
        shutil.rmtree(os.path.join(k, "checkpoints"), ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def run_phase_24(tmp_root, smi, device, npz):
    """Phase 24; returns the launches of its paths."""
    with phase("24, tensor parallelism, sharded serve and ensemble"):
        return check_tp(os.path.join(tmp_root, "tp"), smi, device, npz)


# phase 25: the reference-quirk switches, --debug_nans and the profilers
REF_FLAGS = ("--ref_compat_q_att", "--ref_compat_pos")
# the poisoned --debug_nans child's exit code when it meets FloatingPointError
NAN_EXIT = 3
KERNEL_SYMBOLS = {"B1": "implicit_attention_kernel", "B2": "graph_attention_kernel"}


@contextlib.contextmanager
def step_graphs():
    """Every StepGraphs built in the block (their `graphed` says whether
    each step is a replay)."""
    from tf_vqa_regat_tpu_torch.train import graphs

    real, built = graphs.StepGraphs.__init__, []

    def init(self, *a, **k):
        real(self, *a, **k)
        built.append(self)

    graphs.StepGraphs.__init__ = init
    try:
        yield built
    finally:
        graphs.StepGraphs.__init__ = real


def check_b1_regrouped(device):
    """25 (a): B1's eval variant (b = 1, 32) and train variant (b = 256,
    keep-mask at rate 0.2, gradients through `ImplicitAttention`) on the
    --ref_compat_pos position matrix against the plain version, at the
    bounds of phases 3-4. Returns the largest differences."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia
    from tf_vqa_regat_tpu_torch.ops.position import position_matrix_ref_compat

    s, err = SERVE_SHAPES, {}
    for b in (1, 32):
        x = kernel_inputs(b, device, seed=500 + b, position=position_matrix_ref_compat)
        args = [x[k] for k in KERNEL_ARGS]
        got = ia.fused_implicit_graph_attention(*args)
        err[f"eval_b{b}"] = (got - implicit_reference(*args)).abs().max().item()
        if not torch.isfinite(got).all() or not err[f"eval_b{b}"] <= KERNEL_ATOL:
            fail(f"B1 eval on the regrouped matrix at b={b}: {err}")
    b = 256
    x = kernel_inputs(b, device, seed=756, position=position_matrix_ref_compat)
    g = torch.Generator(device=device).manual_seed(b)
    bits = torch.randint(0, 256, (b, s["R"], s["n"], s["P"]), generator=g, device=device,
                         dtype=torch.uint8)
    dropmask = (bits >= 51).view(torch.uint8)
    G = torch.randn(b, s["R"], s["H"], s["o"], generator=g, device=device)
    args = [x[k] for k in KERNEL_ARGS] + [0.2, dropmask]
    with torch.no_grad():
        out_k, pwr_k, _ = ia.KERNEL(*args, save_pwr=True)
        out_p, pwr_p = implicit_reference(*args, save_pwr=True)

    def fwd_bwd(fn):
        leaves = {k: x[k].clone().requires_grad_() for k in GRAD_ARGS}
        out = fn(*(leaves.get(k, x[k]) for k in KERNEL_ARGS), 0.2, dropmask)
        return dict(zip(GRAD_ARGS, torch.autograd.grad((out * G).sum(),
                                                       [leaves[k] for k in GRAD_ARGS])))

    grads_k = fwd_bwd(ia.fused_implicit_graph_attention)  # the Function
    grads_p = fwd_bwd(ia.implicit_attention_plain)
    err.update(out=(out_k - out_p).abs().max().item(), pwr=(pwr_k - pwr_p).abs().max().item(),
               **{f"d{k}": max_rel(grads_k[k], grads_p[k]) for k in GRAD_ARGS})
    print(f"ref_compat (a) B1 on the --ref_compat_pos matrix (R=100, n=20) vs plain: "
          f"{json.dumps(err)}", flush=True)
    for name, tol in [("out", KERNEL_ATOL), ("pwr", PWR_ATOL), ("dq", GRAD_RTOL),
                      ("dk", GRAD_RTOL), ("dvw", GRAD_RTOL), ("dw_pos", POS_GRAD_RTOL),
                      ("db_pos", POS_GRAD_RTOL)]:
        if not err[name] <= tol:
            fail(f"B1 train on the regrouped matrix: {name} differs by {err[name]} > {tol}")
    return err


def check_padded_serve(npz, device):
    """25 (a): one engine call of 3 requests, padded to the compiled size 8
    (the padded slots enter the batch-axis softmax), and one of 1, against
    the plain path's logits of the same padded batches."""
    import torch

    from tf_vqa_regat_tpu_torch import main as port_main
    from tf_vqa_regat_tpu_torch.serve import InferenceEngine

    argv = entry_argv("implicit", os.path.dirname(npz), "--mode", "serve", "--checkpoint",
                      npz, *REF_FLAGS)
    cfg = port_main.parse(argv)[0]
    ds = port_main.build_dataset(cfg)
    engine = InferenceEngine(cfg, ds, port_main.load_model(cfg, ds), device)
    gaps = {}
    for m, B in ((3, 8), (1, 1)):
        qs, ids = serve_requests(engine, m)
        answers = engine.infer(qs, ids)
        toks = torch.full((B, engine.max_q_len), ds.padding_idx, device=device)
        toks[:m] = torch.tensor([engine._encode(q) for q in qs], device=device)
        img = torch.zeros(B, dtype=torch.int64, device=device)
        img[:m] = torch.tensor([engine.img_index[i] for i in ids], device=device)
        valid = torch.arange(B, device=device) < m
        got = engine.logits(toks, img, valid)
        with plain_kernels():
            want = engine.logits(toks, img, valid)
        gaps[f"{m} in {B}"] = (got - want).abs().max().item()
        scale = want.abs().max().item()
        labels = [ds.label2ans[int(a)] for a in want[:m].argmax(-1)]
        if not gaps[f"{m} in {B}"] <= LOGITS_RTOL * scale \
                or [a["answer"] for a in answers] != labels:
            fail(f"ref_compat serve of {m} padded to {B}: {answers} vs the plain path's "
                 f"{labels}, logits {gaps}")
    print(f"ref_compat (a) serve padded batches, kernel vs plain logits max abs diff "
          f"{json.dumps(gaps)}; answers equal", flush=True)


def check_ref_compat(tmp, smi, device):
    """25 (a) and (b). Returns the launches of their paths."""
    import numpy as np

    from tf_vqa_regat_tpu_torch import main as port_main

    check_b1_regrouped(device)
    out = os.path.join(tmp, "ref")
    with step_graphs() as built:
        npz, train_launches, step_ms = check_entry_point(out, smi, "implicit",
                                                         SHORT_TRAIN + REF_FLAGS)
    if not built or not all(g.graphed for g in built):
        fail("ref_compat (a): a step left its CUDA graph at dp = 1")
    launches = [train_launches,
                check_predict(out, smi, "implicit", npz, device, REF_FLAGS)]
    launches.append(check_serve(npz, "implicit", REF_FLAGS)[0])
    check_padded_serve(npz, device)
    check_graph_row(device, smi, "implicit", REF_FLAGS, 100, "device")

    # (b) two gloo ranks: the softmax over the gathered global batch
    dp_out = os.path.join(tmp, "dp")
    argv = entry_argv("implicit", dp_out, *DP_FLAGS, "--data_mode", "device",
                      "--ref_compat_q_att")
    reports = run_dp_children(os.path.join(tmp, "dp_children"),
                              [{"argv": argv, "kernel": "B1"}], label="ref_compat (b)")
    solo = os.path.join(tmp, "dp_solo")
    reset_counts()
    port_main.main(entry_argv("implicit", solo, *DP_FLAGS, "--data_mode", "device",
                              "--ref_compat_q_att"))
    launches.append(read_path_counts())
    for r, rep in enumerate(reports):
        rec = rep["records"][0]
        want = expected_launches("implicit", rec["eval_passes"], rec["train_steps"])
        if rec["launches"] != want or rec["train_steps"] != DP_STEPS:
            fail(f"ref_compat (b) rank {r}: {rec['train_steps']} steps, launches "
                 f"{rec['launches']}, want {want}")
        launches.append(rank_launches(rec, f"ref_compat (b) rank {r}"))
    ranks = [np.load(os.path.join(tmp, "dp_children", f"params-0-rank{r}.npz")) for r in (0, 1)]
    if not all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0].files):
        fail("ref_compat (b): the ranks' parameters differ")
    two, one = read_run(dp_out), read_run(solo)
    train_rel = max(abs(two[1][e]["train_loss"] - m["train_loss"]) / abs(m["train_loss"])
                    for e, m in one[1].items())
    with open(os.path.join(dp_out, "log.txt")) as fh:
        eager = [line for line in fh if line.startswith("[eager] --ref_compat_q_att at dp=2")]
    step_ms2 = statistics.median(reports[0]["records"][0]["step_ms"])
    print(f"ref_compat (b) --ref_compat_q_att at dp=2 (two gloo ranks on one card) vs one "
          f"rank: train loss rel diff {train_rel} (bound {DP_METRIC_RTOL}); metrics "
          f"{json.dumps(two[1])} vs {json.dumps(one[1])}; eager reason logged "
          f"{bool(eager)}; step median {step_ms2:.3f} ms (CUDA events, eager, the gloo "
          f"collectives staged through the host) on {smi}", flush=True)
    if not train_rel <= DP_METRIC_RTOL or not eager:
        fail(f"ref_compat (b): loss rel diff {train_rel}, eager line {eager}")
    return launches


def nan_child(out):
    """25 (c)'s poisoned run: butd at full width with --debug_nans on a
    train split whose features are all NaN; exits NAN_EXIT on the
    FloatingPointError it must raise."""
    sys.path.insert(0, REPO)
    import numpy as np

    from tf_vqa_regat_tpu_torch import main as port_main

    real = port_main.build_dataset

    def poisoned(cfg, name="val"):
        ds = real(cfg, name)
        if name == "train":
            ds.store.features[:] = np.nan
        return ds

    port_main.build_dataset = poisoned
    try:
        port_main.main(entry_argv("implicit", out, *DP_FLAGS, "--debug_nans"))
    except FloatingPointError as e:
        print(f"FloatingPointError: {e}", flush=True)
        sys.exit(NAN_EXIT)


def trace_summary(path):
    """What a Chrome trace of the train loop holds: the loop's spans, the
    graph launches, the kernels recorded on the device and B1's and B2's
    among them."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = [e.get("name", "") for e in events]
    spans = [e.get("name", "") for e in events if e.get("cat") == "user_annotation"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"data_spans": spans.count("data"), "step_spans": spans.count("step"),
            "graph_launches": sum("cudaGraphLaunch" in n for n in names),
            "kernels": len(kernels),
            **{k: sum(sym in n for n in kernels) for k, sym in KERNEL_SYMBOLS.items()},
            "bytes": os.path.getsize(path)}


def check_debug_and_profile(tmp, smi, device):
    """25 (c)-(e). Returns the launches of their paths."""
    import urllib.error

    from tf_vqa_regat_tpu_torch import main as port_main

    launches = []
    for family in ("implicit", "semantic"):
        name = f"{family}-butd"
        runs = {}
        for label, extra in (("graphed", ()), ("debug_nans", ("--debug_nans",)),
                             ("traced", ("--profile_dir", os.path.join(tmp, f"trace-{family}")))):
            out = os.path.join(tmp, f"{label}-{family}")
            reset_counts()
            with timed_steps() as records, step_graphs() as built:
                port_main.main(entry_argv(family, out, *DP_FLAGS, *extra))
            launches.append(read_path_counts())
            passes = -(-256 // 64)
            if launches[-1] != expected_launches(family, passes, len(records)):
                fail(f"{label} {family}: launches {launches[-1]} for {len(records)} steps")
            graphed = all(g.graphed for g in built)
            if graphed != (label != "debug_nans"):
                fail(f"{label} {family}: steps graphed {graphed}")
            with open(os.path.join(out, "log.txt")) as fh:
                logged = any(line.startswith("[eager] --debug_nans") for line in fh)
            if logged != (label == "debug_nans"):
                fail(f"{label} {family}: the eager reason logged {logged}")
            step_ms = [ev[0].elapsed_time(ev[1]) for _, ev, _, _, cap in records if not cap]
            runs[label] = (read_run(out, name), statistics.median(step_ms))
        (_, graphed_metrics), graphed_ms = runs["graphed"]
        (_, debug_metrics), debug_ms = runs["debug_nans"]
        (_, traced_metrics), traced_ms = runs["traced"]
        rel = max(abs(debug_metrics[e][k] - m[k]) / max(abs(m[k]), 1e-30)
                  for e, m in graphed_metrics.items() for k in ("train_loss", "eval_loss"))
        traces = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(tmp, f"trace-{family}"))
                  for f in fs]
        summary = trace_summary(traces[0]) if len(traces) == 1 else {}
        print(f"debug_nans (c) {CONFIGS[family]} at full width, b=256: clean --debug_nans run "
              f"vs graphed, per-epoch loss max rel diff {rel} (bound {RESUME_RTOL}); train "
              f"step median {debug_ms:.3f} ms eager under --debug_nans vs {graphed_ms:.3f} ms "
              f"graphed (CUDA events, the steps after the capture) on {smi}", flush=True)
        print(f"profile (d) {CONFIGS[family]} --profile_dir: {traces}, {json.dumps(summary)}; "
              f"the traced epoch's train time {traced_metrics[0]['train_time_s']:.3f} s vs "
              f"{graphed_metrics[0]['train_time_s']:.3f} s untraced (host clock, capture "
              f"included), traced step median {traced_ms:.3f} ms vs {graphed_ms:.3f}",
              flush=True)
        if not rel <= RESUME_RTOL:
            fail(f"debug_nans (c) {family}: the clean run differs by rel {rel}")
        # Kineto records the kernels inside a graph replay: each replayed
        # step's 2 launches of the family's kernel are in the trace
        kernel = "B1" if family in B1_FAMILIES else "B2"
        if len(traces) != 1 or summary["step_spans"] != DP_STEPS // 2 \
                or summary["data_spans"] < DP_STEPS // 2 \
                or summary["graph_launches"] < DP_STEPS or summary[kernel] < 2 * DP_STEPS:
            fail(f"profile (d) {family}: traces {traces}, {summary}")
    # the poisoned run, in a child process
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--nan_child",
                            os.path.join(tmp, "poisoned")], cwd=REPO, capture_output=True,
                           text=True, timeout=600)
    said = [line for line in child.stdout.splitlines() if line.startswith("FloatingPointError")]
    print(f"debug_nans (c) poisoned features: exit {child.returncode}, {said}", flush=True)
    if child.returncode != NAN_EXIT or not said or "module" not in said[0]:
        fail(f"debug_nans (c): the poisoned run exited {child.returncode}:\n"
             f"{child.stdout[-3000:]}{child.stderr[-3000:]}")
    # (e) the capture endpoint during a butd run
    port, reply = free_port(), {}

    def client():
        deadline = time.time() + 300
        while time.time() < deadline and not reply:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/capture?duration_ms=500",
                                            timeout=600) as r:
                    reply.update(status=r.status, **json.loads(r.read()))
            except urllib.error.HTTPError as e:
                reply.update(status=e.code, **json.loads(e.read()))
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.05)

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    reset_counts()
    with step_graphs() as built:
        port_main.main(entry_argv("implicit", os.path.join(tmp, "captured"), *DP_FLAGS,
                                  "--profile_port", str(port)))
    launches.append(read_path_counts())
    thread.join(timeout=60)
    trace = reply.get("trace", "")
    summary = trace_summary(trace) if trace and os.path.exists(trace) else {}
    print(f"profile (e) --profile_port: GET /capture?duration_ms=500 -> {json.dumps(reply)}; "
          f"{json.dumps(summary)}", flush=True)
    if reply.get("status") != 200 or not summary.get("bytes") \
            or not all(g.graphed for g in built):
        fail(f"profile (e): {reply}, {summary}")
    return launches


def run_phase_25(tmp_root, smi, device):
    """Phase 25; returns the launches of its paths."""
    import torch

    tmp = os.path.join(tmp_root, "phase25")
    with phase("25 (a)-(b), --ref_compat_q_att --ref_compat_pos"):
        launches = check_ref_compat(tmp, smi, device)
    torch.cuda.empty_cache()
    with phase("25 (c)-(e), --debug_nans, --profile_dir, --profile_port"):
        launches += check_debug_and_profile(tmp, smi, device)
    torch.cuda.empty_cache()
    return launches


# the configurations of the benchmark's three cells, whose dropout sites phase
# 28 holds to the parent's formulation
DROPOUT_FAMILIES = ("implicit", "spatial", "ban")
# two seeds a graph replays with (the second above 2**31, as the benchmark's)
DROPOUT_SEEDS = (20251019, 3_000_000_019)
# tensor-parallel parts a slice of the draw is checked at: (index, parts)
DROPOUT_PARTS = ((0, 2), (1, 2))


@contextlib.contextmanager
def recorded_dropouts(sites):
    """Every dropout call of the port that draws (train, 0 < rate < 1): its
    input's layout, dtype, rate, part and whether it takes a gradient,
    appended to `sites` while open."""
    from tf_vqa_regat_tpu_torch import nn as tnn

    real = tnn.dropout

    def spy(x, rate, train, generator=None, part=None):
        if train and 0.0 < rate < 1.0:
            sites.append({"shape": tuple(x.shape), "stride": tuple(x.stride()),
                          "offset": x.storage_offset(),
                          "storage": x.untyped_storage().nbytes() // x.element_size(),
                          "dtype": x.dtype, "rate": rate, "part": part,
                          "grad": x.requires_grad})
        return real(x, rate, train, generator, part)

    users = [m for name, m in list(sys.modules.items())
             if name.startswith("tf_vqa_regat_tpu_torch") and getattr(m, "dropout", None) is real]
    for m in users:
        m.dropout = spy
    try:
        yield sites
    finally:
        for m in users:
            m.dropout = real


def dropout_step_sites(device, family):
    """One eager train step (forward and gradients) and one eval step of the
    family's full-width model at b=256 (phase 7's batch) -> (the dropout
    sites the train step drew, its kernel launches, the eval step's)."""
    import torch

    from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
    from tf_vqa_regat_tpu_torch.main import build_dataset
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT
    from tf_vqa_regat_tpu_torch.ops.kernels import dropout as kd
    from tf_vqa_regat_tpu_torch.train.step import eval_step, train_forward

    cfg = full_width_config(family, ["--mode", "train"])
    ds = build_dataset(cfg, "train")
    store = DeviceStore(ds, device)
    idx = next(store.epoch_indices(0, cfg.batch_size, True, cfg.seed))
    batch = gather_batch(store, torch.from_numpy(idx).to(device), cfg.resolved_num_rois())
    model = ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans).to(device)
    sites = []
    kd.COUNTS.clear()
    with recorded_dropouts(sites):
        loss, _ = train_forward(model, batch, 0, cfg.seed)
        torch.autograd.grad(loss, list(model.parameters()))
        train = dict(kd.COUNTS)
        kd.COUNTS.clear()
        with torch.no_grad():
            eval_step(model, batch)
        evals = dict(kd.COUNTS)
        if len(sites) != train.get("forward", 0):
            fail(f"dropout {family}: {len(sites)} sites drew in the train step, the kernel "
                 f"ran {train.get('forward', 0)} forward launches")
    torch.cuda.synchronize()
    del model, store, batch
    torch.cuda.empty_cache()
    kd.COUNTS.clear()
    return sites, train, evals


def dropout_parent(x, bits, t, scale, dy):
    """The parent's formulation and its autograd: (out, dx)."""
    import torch

    out = torch.where(bits >= t, x * scale, torch.zeros_like(x))
    return out, torch.autograd.grad(out, x, dy)[0]


def same_bits(a, b) -> bool:
    import torch

    view = torch.int32 if a.element_size() == 4 else torch.int16
    return a.shape == b.shape and torch.equal(a.contiguous().view(view),
                                              b.contiguous().view(view))


def check_dropout_layout(device, site, dtype):
    """Site `site`'s layout in `dtype`: nn.dropout forward and its gradient
    inside a captured graph replayed at DROPOUT_SEEDS, bit for bit against
    the parent's formulation on the draw of the same seed, in bits and in
    strides, and the launches each replay adds. Returns (the values
    compared, their largest absolute difference)."""
    import torch

    from tf_vqa_regat_tpu_torch import nn as tnn
    from tf_vqa_regat_tpu_torch.ops.kernels import dropout as kd
    from tf_vqa_regat_tpu_torch.train.graphs import StepGraphs

    shape, stride, offset, rate, part = (site[k] for k in ("shape", "stride", "offset", "rate",
                                                            "part"))
    gen = torch.Generator(device=device).manual_seed(7)
    base = torch.randn(site["storage"], generator=gen, device=device).to(dtype)
    base.requires_grad_(True)
    dy = torch.randn(shape, generator=gen, device=device).to(dtype)

    def step(key, inputs, generators):
        x = base.as_strided(shape, stride, offset)
        out = tnn.dropout(x, rate, True, generators[0], part)
        return {"out": out, "dx": torch.autograd.grad(out, x, dy)[0]}

    graphs = StepGraphs(step, device, generators=1)
    t = tnn.drop_threshold(rate)
    scale = 256.0 / (256 - t)
    if dtype != torch.float32:
        scale = float(torch.tensor(scale, dtype=dtype))
    outs, err = [], 0.0
    for i, seed in enumerate(DROPOUT_SEEDS):
        before = dict(kd.COUNTS)
        got = {k: v.clone() for k, v in graphs("step", {}, (seed,)).items()}
        added = {k: kd.COUNTS[k] - before.get(k, 0) for k in ("forward", "backward")}
        if added != {"forward": 1, "backward": 1}:
            fail(f"dropout {shape} {dtype}: a replay added {added} launches")
        g = torch.Generator(device=device).manual_seed(seed)
        if part is None:
            bits = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8, device=device)
        else:
            j, n = part
            w = shape[-1]
            bits = torch.randint(0, 256, shape[:-1] + (w * n,), generator=g,
                                 dtype=torch.uint8, device=device)[..., j * w:(j + 1) * w]
        leaf = base.detach().requires_grad_(True)
        want = dropout_parent(leaf.as_strided(shape, stride, offset), bits, t, scale, dy)
        for name, a, b in (("out", got["out"], want[0]), ("dx", got["dx"], want[1])):
            diff = (a.float() - b.float()).abs().max().item()
            err = max(err, diff)
            # the layout too: the layers after a site read what they read before
            if not same_bits(a, b) or a.stride() != b.stride():
                fail(f"dropout {shape} strides {stride} part {part} {dtype} seed {seed}: "
                     f"{name} differs from the parent's formulation (max abs {diff}, "
                     f"strides {a.stride()} vs {b.stride()})")
        outs.append(got["out"])
    if same_bits(outs[0], outs[1]):
        fail(f"dropout {shape} {dtype}: two seeds drew the same mask")
    del graphs
    return 2 * len(DROPOUT_SEEDS) * math.prod(shape), err


def dropout_bound_ms(numel, itemsize) -> float:
    """Input and output once each and a byte of bits, over the HBM rate."""
    return numel * (2 * itemsize + 1) / HBM_BYTES_PER_S * 1e3


def time_dropout(device, site, dtype):
    """The kernel's forward (on x) and backward (on dy) against the parent's
    chain (`>= t`, `x * scale`, `zeros_like`, `where`; autograd's `where`
    against 0 and `* scale`) at the site's layout, timed in turns."""
    import torch

    from tf_vqa_regat_tpu_torch import nn as tnn
    from tf_vqa_regat_tpu_torch.ops.kernels import dropout as kd

    shape, stride, offset = site["shape"], site["stride"], site["offset"]
    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn(site["storage"], generator=gen, device=device).to(dtype).as_strided(
        shape, stride, offset)
    dy = torch.randn(shape, generator=gen, device=device).to(dtype)
    bits = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8, device=device)
    t = tnn.drop_threshold(site["rate"])
    scale = float(torch.tensor(256.0 / (256 - t), dtype=dtype))
    zero = torch.zeros((), dtype=dtype, device=device)
    keep = bits >= t
    calls = 20
    fwd, bwd, fwd_p, bwd_p = (ms / calls for ms in median_graph_ms([
        lambda: kd.kernel(x, bits, t, scale, "forward"),
        lambda: kd.kernel(dy, bits, t, scale, "backward"),
        lambda: torch.where(bits >= t, x * scale, torch.zeros_like(x)),
        lambda: torch.where(keep, dy, zero) * scale], calls=calls))
    kd.COUNTS.clear()
    numel = math.prod(shape)
    xr, br = kd.launch_rows(x, bits)
    return {"forward_ms": fwd, "backward_ms": bwd, "parent_forward_ms": fwd_p,
            "parent_backward_ms": bwd_p, "bound_ms": dropout_bound_ms(numel, x.element_size()),
            "copied": [n for n, a, b in (("x", x, xr), ("bits", bits, br))
                       if a.data_ptr() != b.data_ptr()]}


def check_dropout(device, smi):
    """Phase 28: dropout's kernel at every dropout site of the benchmark
    cells' train steps. Returns the kernels-line entry."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.kernels import dropout as kd

    kd.LIB.load()
    per_step, layouts = {}, {}
    for family in DROPOUT_FAMILIES:
        sites, train, evals = dropout_step_sites(device, family)
        grads = sum(s["grad"] for s in sites)
        per_step[CONFIGS[family]] = {"sites": len(sites), "sites_with_grad": grads,
                                     "train": train, "eval": evals}
        print(f"dropout {family} b={sites[0]['shape'][0]}: {len(sites)} sites draw in a train step "
              f"({grads} take a gradient), launches train {json.dumps(train)}, eval "
              f"{json.dumps(evals)}; sites "
              f"{[(s['shape'], s['stride'], s['rate'], s['grad']) for s in sites]}", flush=True)
        if train.get("backward", 0) != grads or evals:
            fail(f"dropout {family}: {train} train launches for {len(sites)} sites "
                 f"({grads} with a gradient), eval launches {evals}")
        for s in sites:
            key = (s["shape"], s["stride"], s["offset"], s["storage"], s["rate"], s["part"])
            site = layouts.setdefault(key, dict(s, uses=collections.Counter(),
                                                grads=collections.Counter()))
            site["uses"][family] += 1
            site["grads"][family] += s["grad"]
    # the tensor-parallel slices of the draw, at the classifier's hidden layer
    cls = max((s for s in layouts.values() if len(s["shape"]) == 2),
              key=lambda s: s["shape"][-1])
    for part in DROPOUT_PARTS:
        w = cls["shape"][-1] // part[1]
        shape = cls["shape"][:-1] + (w,)
        layouts[("part", part)] = dict(cls, shape=shape, stride=(w, 1), offset=0,
                                       storage=math.prod(shape), part=part)
    compared, err = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for site in layouts.values():
            n, e = check_dropout_layout(device, site, dtype)
            compared, err = compared + n, max(err, e)
            torch.cuda.empty_cache()
    print(f"dropout: {len(layouts)} layouts x f32, bf16 x {len(DROPOUT_SEEDS)} seeds, "
          f"forward and gradient in a replayed graph: {compared} values equal the parent's "
          f"formulation bit for bit and in layout (max abs difference {err})", flush=True)
    rows = []
    for key, site in layouts.items():
        if key[0] == "part":
            continue
        for dtype in (torch.float32, torch.bfloat16):
            row = time_dropout(device, site, dtype)
            row.update(shape=site["shape"], stride=site["stride"], dtype=str(dtype)[6:],
                       uses=dict(site["uses"]), grads=dict(site["grads"]))
            rows.append(row)
            print(f"dropout {site['shape']} strides {site['stride']} {row['dtype']}: "
                  f"{json.dumps({k: v for k, v in row.items() if k.endswith('ms') or k == 'copied'})}"
                  f" on {smi}", flush=True)
            torch.cuda.empty_cache()
    totals = {}
    for family in DROPOUT_FAMILIES:
        tot = collections.Counter()
        for r in rows:
            if r["dtype"] != "float32":
                continue
            n, g = r["uses"].get(family, 0), r["grads"].get(family, 0)
            for what, k in (("forward", n), ("backward", g)):
                tot[f"{what}_ms"] += k * r[f"{what}_ms"]
                tot[f"parent_{what}_ms"] += k * r[f"parent_{what}_ms"]
                tot["bound_ms"] += k * r["bound_ms"]
        totals[CONFIGS[family]] = {k: round(v, 4) for k, v in tot.items()}
    print(f"dropout per f32 train step (sum over its sites, the draw left out): "
          f"{json.dumps(totals)} on {smi}", flush=True)
    big = max((r for r in rows if r["dtype"] == "float32" and r["uses"].get("implicit")),
              key=lambda r: math.prod(r["shape"]))
    return {
        "name": "dropout", "route": "cuda", "source": "tf_vqa_regat_tpu_torch/csrc/dropout.cu",
        "replaces": None, "launches_per_step": per_step, "max_abs_err": err,
        "ms": big["forward_ms"], "backward_ms": big["backward_ms"],
        "plain_ms": big["parent_forward_ms"], "plain_backward_ms": big["parent_backward_ms"],
        "bound_ms": big["bound_ms"], "bound_by": "bytes", "shape": big["shape"],
        "library_ms": None, "per_step": totals,
    }


def run_phase_26(tmp_root, smi, device):
    """`--only 26`: phase 4, phase 26, and 8-9 for the implicit family."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    resources = kernel_resources(ia, "implicit_attention_kernel", ("eval", "train"))
    print("B1 backward ptxas", json.dumps(backward_resources(ia, "implicit_attention_bwd_kernel")),
          flush=True)
    with phase("4, B1 train variant"):
        check_train_kernel(device, resources)
    with phase("26, B1 backward"):
        check_backward_kernel(device)
    torch.cuda.empty_cache()
    with phase("8-9, implicit train and eval"):
        check_entry_point(os.path.join(tmp_root, "implicit"), smi, "implicit", SHORT_TRAIN)
    with phase("26, implicit train and eval at other widths"):
        check_entry_point(os.path.join(tmp_root, "widths"), smi, "implicit",
                          SHORT_TRAIN + OTHER_WIDTHS)


def run_phase_27(tmp_root, smi, device):
    """`--only 27`: B2's phases 5, 6 and 27, then 7 and 8-9 for the spatial
    family (whose train runs must count one B2 backward launch per forward
    launch under grad)."""
    import torch

    from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga

    print("B2 backward ptxas", json.dumps(backward_resources(
        ga, "graph_attention_bwd_kernel", (" v2", " v1"))), flush=True)
    with phase("5, B2"):
        check_graph_kernel(device, kernel_resources(ga, "graph_attention_kernel", ("v2", "v1")))
    with phase("6, B2 gradients"):
        check_graph_grads(device)
    with phase("27, B2 backward"):
        check_graph_backward(device)
    torch.cuda.empty_cache()
    with phase("7, spatial train step"):
        split, peak_gb = check_train_step(device, "spatial")
    print(f"spatial train step split at b=256, median ms (CUDA events, TF32 off) on {smi}: "
          f"{json.dumps(split)}; peak device memory {peak_gb:.2f} GB", flush=True)
    torch.cuda.empty_cache()
    with phase("8-9, spatial train and eval"):
        check_entry_point(os.path.join(tmp_root, "spatial"), smi, "spatial", SHORT_TRAIN)


def run_phase_28(tmp_root, smi, device):
    """`--only 28`: dropout's kernel alone."""
    with phase("28, dropout"):
        check_dropout(device, smi)


def build_kernels():
    """Build every CUDA source of the port, one nvcc each, all at once."""
    from tf_vqa_regat_tpu_torch.ops.kernels import build
    from tf_vqa_regat_tpu_torch.ops.kernels import dropout as kd
    from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga
    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        libs = list(pool.map(build.build, (ia.SOURCE, ga.SOURCE, kd.SOURCE)))
    for module in (ia, ga, kd):
        module.LIB.load()
    print(f"built {[os.path.relpath(so, REPO) for so in libs]} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for so in libs:
        log = so.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", help="another checkout whose B1 and B2 phases 3-5 "
                        "time in turns with this one")
    parser.add_argument("--only", choices=("23", "24", "25", "26", "27", "28"),
                        help="build the kernels and run this phase alone (no result line)")
    parser.add_argument("--dp_child", nargs=2, metavar=("SPEC", "RANK"),
                        help=argparse.SUPPRESS)  # one rank of phase 23 (b)
    parser.add_argument("--tp_child", nargs=2, metavar=("SPEC", "RANK"),
                        help=argparse.SUPPRESS)  # one rank of phase 24
    parser.add_argument("--control_child", nargs=2,
                        help=argparse.SUPPRESS)  # phase 24's controls: OUT KIND
    parser.add_argument("--nan_child", help=argparse.SUPPRESS)  # phase 25 (c)'s poisoned run
    args = parser.parse_args()
    if args.control_child:
        control_child(*args.control_child)
        return
    if args.nan_child:
        nan_child(args.nan_child)
        return
    if args.dp_child:
        dp_child(args.dp_child[0], int(args.dp_child[1]))
        return
    if args.tp_child:
        tp_child(args.tp_child[0], int(args.tp_child[1]))
        return
    start = time.perf_counter()
    if not os.path.isdir(os.path.join(REPO, "tf_vqa_regat_tpu_torch")):
        fail("run from the root of a checkout: tf_vqa_regat_tpu_torch/ is missing")
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    with phase("2, build"):
        build_kernels()

    device = torch.device("cuda", 0)
    smi_line = smi.stdout.strip().splitlines()[0]
    if args.only:
        with tempfile.TemporaryDirectory() as tmp_root:
            {"23": run_phase_23, "24": lambda *a: run_phase_24(*a, {}),
             "25": run_phase_25, "26": run_phase_26, "27": run_phase_27,
             "28": run_phase_28}[args.only](tmp_root, smi_line, device)
        print(f"phase {args.only} alone: {time.perf_counter() - start:.1f} s wall; no result "
              f"line", flush=True)
        return
    from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga
    from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

    b1_resources = kernel_resources(ia, "implicit_attention_kernel", ("eval", "train"))
    b1_baseline = load_baseline(args.baseline, "implicit_attention")
    with phase("3, B1 eval variant"):
        rows = check_kernels(device, b1_resources, b1_baseline)
    with phase("4, B1 train variant"):
        train_rows = check_train_kernel(device, b1_resources, b1_baseline)
    print("B1 backward ptxas", json.dumps(backward_resources(ia, "implicit_attention_bwd_kernel")),
          flush=True)
    with phase("26, B1 backward"):
        bwd_rows = check_backward_kernel(device)
    torch.cuda.empty_cache()
    with phase("5, B2"):
        graph_rows = check_graph_kernel(device, kernel_resources(
            ga, "graph_attention_kernel", ("v2", "v1")),
            load_baseline(args.baseline, "graph_attention"))
    with phase("6, B2 gradients"):
        check_graph_grads(device)
    print("B2 backward ptxas", json.dumps(backward_resources(
        ga, "graph_attention_bwd_kernel", (" v2", " v1"))), flush=True)
    with phase("27, B2 backward"):
        graph_bwd_rows = check_graph_backward(device)
    torch.cuda.empty_cache()
    rows_at = {}
    for R in ROWS:
        with phase(f"14, B1 and B2 at R={R}"):
            rows_at[R] = check_kernels_at_rows(device, R)
    for family, extra in (("implicit", ()), ("spatial", ()), ("semantic", ()), ("ban", ()),
                          ("mutan", ()), ("mutan", ("--mutan_shared_qdrop",))):
        label = " ".join([family, *extra])
        with phase(f"7, {label} train step"):
            split, peak_gb = check_train_step(device, family, extra)
        torch.cuda.empty_cache()
        print(f"{label} train step split at b=256, median ms (CUDA events, TF32 off) on "
              f"{smi_line}: {json.dumps(split)}; peak device memory {peak_gb:.2f} GB",
              flush=True)
    with phase("7, mutan formulations"):
        check_mutan_branches(device)
    torch.cuda.empty_cache()
    with phase("28, dropout"):
        dropout_row = check_dropout(device, smi_line)
    torch.cuda.empty_cache()
    with phase("15, feature tables"):
        check_tables(device)
    torch.cuda.empty_cache()
    with phase("16, bf16 train step"):
        check_bf16_step(device, smi_line)
    torch.cuda.empty_cache()
    for family, extra in (("ban", ()), ("mutan", ()), ("mutan", ("--mutan_shared_qdrop",))):
        with phase(f"16, {' '.join([family, *extra])} bf16 train step"):
            check_bf16_fusion_step(device, smi_line, family, extra)
        torch.cuda.empty_cache()
    launches = []  # the launch counts of every path of 8-13 and 17-21
    npz = {}
    with tempfile.TemporaryDirectory() as tmp_root:
        for family in CONFIGS:
            tmp = os.path.join(tmp_root, family)
            with phase(f"8-9, {family} train and eval"):
                npz[family], train_launches, _ = check_entry_point(tmp, smi_line, family,
                                                                   SHORT_TRAIN)
            with phase(f"10, {family} serve"):
                serve_launches, _, _ = check_serve(npz[family], family)
            shutil.rmtree(os.path.join(tmp, "checkpoints"))
            torch.cuda.empty_cache()
            launches += [train_launches, serve_launches]
        with phase("26, implicit train and eval at other widths"):
            launches.append(check_entry_point(os.path.join(tmp_root, "widths"), smi_line,
                                              "implicit", SHORT_TRAIN + OTHER_WIDTHS)[1])
        torch.cuda.empty_cache()
        with phase("11, resume"):
            launches.append(check_resume(os.path.join(tmp_root, "resume"), smi_line, device))
        torch.cuda.empty_cache()
        for family in CONFIGS:
            with phase(f"12, {family} predict"):
                launches.append(check_predict(os.path.join(tmp_root, family), smi_line, family,
                                              npz[family], device))
            torch.cuda.empty_cache()
        with phase("13, ensemble"):
            launches += check_ensemble(tmp_root, smi_line, npz, device)
        torch.cuda.empty_cache()
        for family in ("implicit", "spatial", "ban", "mutan"):
            with phase(f"17, {family} at the bench's settings"):
                paths, _, path = check_bench_settings(
                    os.path.join(tmp_root, f"bench_{family}"), smi_line, family, SHORT_TRAIN)
                launches += paths
                if family in ("ban", "mutan"):
                    launches.append(check_serve(path, family, BENCH_FLAGS, bf16=True)[0])
            torch.cuda.empty_cache()
        with phase("18, fixed-36"):
            launches += check_fixed36(tmp_root, smi_line, device)
        torch.cuda.empty_cache()
        with phase("19, real-layout data"):
            launches += check_realdata(tmp_root, smi_line, device)
        torch.cuda.empty_cache()
        for family, naive in (("implicit", False), ("mutan", True)):
            with phase(f"20, {family} --grad_accum 1, 2, 4"):
                launches += check_grad_accum(device, smi_line, family, naive)[1]
            torch.cuda.empty_cache()
        with phase("20, --grad_accum 2 resume"):
            launches += check_grad_accum_resume(os.path.join(tmp_root, "accum"), smi_line)
        torch.cuda.empty_cache()
        with phase("21, host streaming"):
            launches += check_host_streaming(tmp_root, smi_line, device)
        torch.cuda.empty_cache()
        with phase("22, graphs: train steps"):
            check_graphs_train(device, smi_line)
        torch.cuda.empty_cache()
        with phase("22, graphs: eval, predict, ensemble, serve"):
            check_graphs_eval_serve(os.path.join(tmp_root, "graphs"), smi_line, device, npz)
        torch.cuda.empty_cache()
        launches += run_phase_23(tmp_root, smi_line, device)
        launches += run_phase_24(tmp_root, smi_line, device, npz)
        launches += run_phase_25(tmp_root, smi_line, device)

    if any(m.split(".")[0] in ("jax", "jaxlib", "tf_vqa_regat_tpu") for m in sys.modules):
        fail("JAX or the JAX package was imported")
    print(f"all phases: {time.perf_counter() - start:.1f} s wall", flush=True)
    b1_source = "tf_vqa_regat_tpu_torch/csrc/implicit_attention.cu"
    b2_source = "tf_vqa_regat_tpu_torch/csrc/graph_attention.cu"
    # B1 eval at b=32, the largest serve batch; the others at b=256
    big = next(r for r in rows if r["b"] == 32)
    train_big, graph_big, bwd_big = train_rows[-1], graph_rows[-1], bwd_rows[0]
    graph_bwd_big = graph_bwd_rows[0]
    bound_keys = ("bound_ms", "bound_by")
    def total(kernel):  # over every path of 8-21, all R
        return sum(run[kernel] for run in launches)

    if sum(PATH_BACKWARD) != total("B1 train"):
        fail(f"{sum(PATH_BACKWARD)} B1 backward launches over the paths for "
             f"{total('B1 train')} train launches")

    # dropout's launches over every path that read its counts, each held to
    # its train microbatches' sites
    if not any(d["microbatches"] for d in PATH_DROPOUT):
        fail("no path trained with dropout on")
    by_direction = {k: sum(d[k] for d in PATH_DROPOUT) for k in ("forward", "backward")}
    dropout_row.update(launches=sum(by_direction.values()), launches_by_direction=by_direction,
                       train_microbatches=sum(d["microbatches"] for d in PATH_DROPOUT))

    def at_rows(kernel, R):  # over every path of 8-21, at R
        return sum(run.get((kernel, R), 0) for run in PATH_ROWS)

    def rows_entries(R):
        """B1's two variants and B2 at R (14's rows: B1 eval at b=32, the
        others at b=256); launches at R over the paths of 8-21."""
        by_b = {r["b"]: r for r in rows_at[R]}
        small, big = by_b[32], by_b[256]
        return [{
            "name": f"implicit_attention R={R}", "route": "cuda", "source": b1_source,
            "replaces": "tf_vqa_regat_tpu/ops/pallas/implicit_attention.py:99",
            "launches": at_rows("B1 eval", R),
            "max_abs_err": max(r["b1_err"] for r in rows_at[R]),
            "ms": small["b1_ms"], "plain_ms": small["b1_plain_ms"],
            "bound_ms": small["b1_bound_ms"], "bound_by": small["b1_bound_by"],
            "library_ms": None,
        }, {
            "name": f"implicit_attention_train R={R}", "route": "cuda", "source": b1_source,
            "replaces": "tf_vqa_regat_tpu/ops/pallas/implicit_attention.py:208",
            "launches": at_rows("B1 train", R),
            "max_abs_err": max(max(r["b1_train_out_err"], r["b1_train_pwr_err"])
                               for r in rows_at[R]),
            "ms": big["b1_train_ms"], "plain_ms": big["b1_train_plain_ms"],
            "bound_ms": big["b1_train_bound_ms"], "bound_by": big["b1_train_bound_by"],
            "library_ms": None,
        }, {
            "name": f"graph_attention R={R}", "route": "cuda", "source": b2_source,
            "replaces": "tf_vqa_regat_tpu/ops/pallas/graph_attention.py:66",
            "launches": at_rows("B2", R),
            "max_abs_err": max(max(r["b2_shared_err"], r["b2_per_head_err"])
                               for r in rows_at[R]),
            "ms": big["b2_ms"], "plain_ms": big["b2_plain_ms"],
            "bound_ms": big["b2_bound_ms"], "bound_by": big["b2_bound_by"],
            "library_ms": big["sdpa_ms"],
        }]

    print(json.dumps({"kernels": [{
        "name": "implicit_attention",
        "route": "cuda",
        "source": b1_source,
        "replaces": "tf_vqa_regat_tpu/ops/pallas/implicit_attention.py:99",
        "launches": total("B1 eval"),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        **{k: big[k] for k in bound_keys},
        "library_ms": None,
    }, {
        "name": "implicit_attention_train",
        "route": "cuda",
        "source": b1_source,
        "replaces": "tf_vqa_regat_tpu/ops/pallas/implicit_attention.py:208",
        "launches": total("B1 train"),
        "max_abs_err": max(max(r["out"], r["pwr"]) for r in train_rows),
        "ms": train_big["fwd_ms"],
        "plain_ms": train_big["fwd_plain_ms"],
        **{k: train_big[k] for k in bound_keys},
        "library_ms": None,
    }, {
        "name": "implicit_attention_backward",
        "route": "cuda",
        "source": b1_source,
        "replaces": "tf_vqa_regat_tpu/ops/pallas/implicit_attention.py:259",
        "launches": sum(PATH_BACKWARD),
        "max_rel_err": max(max(r[n] for n in ("dq", "dk", "dvw", "dw_pos", "db_pos"))
                           for r in bwd_rows),
        "ms": bwd_big["bwd_ms"],
        "plain_ms": bwd_big["bwd_transcription_ms"],
        **{k: bwd_big[k] for k in bound_keys},
        "library_ms": None,
    }, {
        "name": "graph_attention",
        "route": "cuda",
        "source": b2_source,
        "replaces": "tf_vqa_regat_tpu/ops/pallas/graph_attention.py:66",
        "launches": total("B2"),
        "max_abs_err": max(max(r["v2_shared_err"], r["v2_per_head_err"]) for r in graph_rows),
        "ms": graph_big["ms"],
        "plain_ms": graph_big["plain_ms"],
        **{k: graph_big[k] for k in bound_keys},
        "library_ms": graph_big["sdpa_ms"],
    }, {
        "name": "graph_attention_backward",
        "route": "cuda",
        "source": b2_source,
        "replaces": "tf_vqa_regat_tpu/ops/pallas/graph_attention.py:218",
        "launches": sum(PATH_B2_BACKWARD),
        "max_rel_err": max(max(r[n] for n in ("dq", "dk", "dvw", "dbias"))
                           for r in graph_bwd_rows),
        "ms": graph_bwd_big["bwd_ms"],
        "plain_ms": graph_bwd_big["bwd_transcription_ms"],
        **{k: graph_bwd_big[k] for k in bound_keys},
        "library_ms": None,
    }, {
        "name": "graph_attention_per_head",
        "route": "cuda",
        "source": b2_source,
        "replaces": "tf_vqa_regat_tpu/ops/pallas/graph_attention.py:43",
        "launches": total("B2 per-head"),
        "max_abs_err": max(max(r["v1_shared_err"], r["v1_per_head_err"]) for r in graph_rows),
        "ms": graph_big["v1_ms"],
        "plain_ms": graph_big["v1_plain_ms"],
        **{k: graph_big[k] for k in bound_keys},
        "library_ms": graph_big["sdpa_ms"],
    }, dropout_row, *(e for R in ROWS for e in rows_entries(R))]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
