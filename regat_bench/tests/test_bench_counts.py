"""The yardstick's arithmetic against hand counts at small shapes: the
model's operations per question, B1's and B2's bytes and operations, the
roofline and utilization shares."""

import pytest

from regat_bench import flops

SMALL = {"num_hid": 8, "relation_dim": 16, "num_heads": 4, "nongt_dim": 3, "max_boxes": 5,
         "max_q_len": 2, "op": "c", "num_ans": 7, "v_dim": 10, "dir_num": 2,
         "imp_pos_emb_dim": 32, "spa_label_num": 11, "relation_type": "implicit",
         "fusion": "butd"}


def test_forward_flops_by_hand():
    h, rel, H, R, n, T, A, v, P = 8, 16, 4, 5, 3, 2, 7, 10, 32
    dh = rel // H
    lang = 2 * T * 600 * 3 * h + 2 * T * h * 3 * h + 2 * T * h * h + 2 * T * h + 2 * T * h
    vis = 2 * R * v * rel + 2 * R * (rel + h) * rel
    per_dir = (2 * R * rel * rel + 2 * n * rel * rel + 2 * n * rel * rel
               + 2 * R * H * n * dh * 2 + 2 * R * n * P * H)
    butd = 2 * R * rel * h + 2 * h * h + 2 * R * h + 2 * R * rel + 2 * rel * h + 2 * h * h
    cls = 2 * h * 2 * h + 2 * 2 * h * A
    assert flops.forward_flops(SMALL) == lang + vis + 2 * per_dir + butd + cls


def test_train_flops_counts_input_gradients_only_where_needed():
    fwd = flops.forward_flops(SMALL)
    no_input_grad = 2 * 5 * 10 * 16 + 2 * (2 * 5 * 3 * 32 * 4)  # v2out, both pos-FCs
    assert flops.train_flops(SMALL) == 3 * fwd - no_input_grad


def test_spatial_swaps_the_pos_fc_for_the_label_fc():
    sp = dict(SMALL, relation_type="spatial")
    diff = flops.forward_flops(SMALL) - flops.forward_flops(sp)
    assert diff == 2 * (2 * 5 * 3 * 32 * 4) - 2 * (2 * 5 * 3 * 11)


def test_semantic_label_fc_counts_the_semantic_labels():
    sp = dict(SMALL, relation_type="spatial")
    sem = dict(SMALL, relation_type="semantic", sem_label_num=15)
    assert flops.forward_flops(sem) - flops.forward_flops(sp) == 2 * (2 * 5 * 3 * (15 - 11))


def test_b1_and_b2_cost_by_hand():
    b, R, n, H, dh, P = 2, 5, 3, 4, 4, 32
    q, kv, pos, out = b * R * H * dh, b * n * H * dh, b * R * n * 4, b * R * H * dh
    eval_bytes = 4 * (q + 2 * kv + pos + P * H + H + out) + b * n
    assert flops.b1_cost(SMALL, b, False) == (eval_bytes, 2 * b * R * H * n * (dh + P + dh))
    assert flops.b1_cost(SMALL, b, True)[0] == eval_bytes + b * R * n * P
    assert flops.b2_cost(SMALL, b) == (4 * (2 * q + 2 * kv + b * R * n),
                                       2 * b * R * H * n * 2 * dh)


def test_roofline_and_mfu():
    # bytes-bound: 3.35e9 bytes take 1 ms at the HBM rate
    assert flops.roofline_percent(3.35e9, 1.0, 2e-3) == pytest.approx(50.0)
    # operations-bound: 67e9 operations take 1 ms at the f32 peak
    assert flops.roofline_percent(1.0, 67e9, 4e-3) == pytest.approx(25.0)
    assert flops.mfu_percent(67e9, 10, 1.0, chips=1) == pytest.approx(1.0)
    assert flops.mfu_percent(67e9, 10, 1.0, chips=4) == pytest.approx(0.25)


def test_published_widths_butd():
    cfg = dict(SMALL, num_hid=768, relation_dim=1024, num_heads=16, nongt_dim=20,
               max_boxes=100, max_q_len=14, num_ans=3129, v_dim=2048, imp_pos_emb_dim=64)
    fwd = flops.forward_flops(cfg)
    assert 1.5e9 < fwd < 1.8e9
    assert 2.5 * fwd < flops.train_flops(cfg) < 3 * fwd


def test_recorded_counts_the_hand_written_kernels_inside_the_spans():
    from regat_bench import kernels, tracing

    trace = tracing.Trace("cpu")
    trace.spans = [("train_pass", 0, 100), ("eval_pass", 100, 200)]
    trace.device_ops = [("void implicit_attention_kernel<true>(Params)", 10, 20),
                        ("void implicit_attention_kernel<false>(Params)", 110, 120),
                        ("void graph_attention_kernel<false>(Params)", 130, 140),
                        ("sm80_xmma_gemm_f32f32", 30, 40),
                        ("void graph_attention_kernel<false>(Params)", 250, 260)]
    assert kernels.recorded(trace, ("train_pass", "eval_pass")) == 3
    assert kernels.recorded(trace, ("train_pass",)) == 1
    counts = [({"train_launches": 2, "launches": 3}, None), ({"launches": 4}, None)]
    assert kernels.launched(counts) == 9
