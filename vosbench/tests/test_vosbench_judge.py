"""The numbers that decide ``correct``, by hand: the stream's gaps, the
ratio to the float8 yardstick, the free-running start, and the training
numbers (the read's heads each over its own norm, the first step's
estimates)."""

import numpy as np
import torch

from vosbench import harness, manifest
from vosbench.reference import rmnet_ref

S = manifest.driver("stream")
D = manifest.driver("train")


def _tiny_reference(seed=0):
    torch.manual_seed(seed)
    rm, tfn = rmnet_ref.build(loose=6)
    rm, tfn = rm.to_empty(device="cpu"), tfn.to_empty(device="cpu")
    for p in list(rm.parameters()) + list(tfn.parameters()):
        torch.nn.init.normal_(p, std=0.02)
    for m in rm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return rm.eval(), tfn.eval()


def test_numbers_by_hand():
    gap = [0.2, 0.01, 0.01, 0.02, 0.9]  # frame 5: a flipped box decision
    yard = [0.4, 0.1, 0.1, 0.1, 0.1]
    n = S.numbers(gap, yard, [0.1, 0.3])
    assert abs(n["prob_gap_mean"] - 0.228) < 1e-12 and n["prob_gap_frame"] == 0.9
    assert abs(n["prob_gap_ratio"] - 0.2) < 1e-12  # median 0.02 over median 0.1
    assert n["prob_gap_first_ratio"] == 0.5 and abs(n["prob_gap_free"] - 0.2) < 1e-12
    assert set(S.numbers(gap)) == {"prob_gap_mean", "prob_gap_frame"}


def test_frame_gaps_skip_the_given_frame():
    got = torch.zeros(5, 2, 4, 4)
    ref = torch.zeros(3, 2, 4, 4)
    ref[0] = 1.0  # frame 0 is the given masks: not judged
    ref[2] = 0.5
    assert S.frame_gaps(got, ref) == [0.0, 0.5]


def test_a_stopped_reference_run_is_the_start_of_the_whole_one():
    """``stop`` ends the loop early and keeps the object rows of the whole
    clip: an object first given late still takes its row from frame 1 on."""
    rm, tfn = _tiny_reference()
    T, H, W = 5, 32, 48
    frames = torch.rand(T, H, W, 3) * 2 - 1
    masks = torch.zeros(T, 3, H, W)
    masks[:, 0] = 1
    masks[:, 0, 4:12, 4:12], masks[:, 1, 4:12, 4:12] = 0, 1
    masks[4, 0, 16:28, 20:40], masks[4, 2, 16:28, 20:40] = 0, 1
    n_objects = [1, 1, 1, 1, 2]
    with torch.no_grad():
        whole = rmnet_ref.infer(rm, tfn, frames, masks, n_objects, 2)
        start = rmnet_ref.infer(rm, tfn, frames, masks, n_objects, 2, stop=3)
        cut = rmnet_ref.infer(rm, tfn, frames[:3], masks[:3], n_objects[:3], 2)
    assert torch.equal(start[:3], whole[:3]) and not start[3:].any()
    assert not torch.allclose(cut, whole[:3])  # one object row fewer


def test_read_heads_each_over_their_own_norm():
    want = {"kv_query.key_conv.weight": 2.0, "kv_memory.key_conv.weight": 1.0,
            "kv_memory.value_conv.bias": 4.0, "decoder.w": 100.0}
    got = dict(want, **{"kv_query.key_conv.weight": 3.0, "decoder.w": 150.0})
    names = [k for k in want if k.startswith(D.READ_HEADS)]
    assert names == list(want)[:3]
    assert D.own_gap(got, want, names) == 0.5
    # beside large leaves, the median leaf's norm hides it
    big = {"decoder.w": 100.0, "x": 100.0, "y": 100.0}
    assert D.worst_leaf(dict(got, **big), dict(want, **big)) == 1 / 52


def test_compare_reads_the_first_steps_estimates_and_leaves_still_heads_out():
    names = ["kv_query.key_conv.weight", "kv_memory.key_conv.bias", "a", "b"]
    g_ref = {"kv_query.key_conv.weight": torch.ones(4), "kv_memory.key_conv.bias": torch.zeros(4)
             + 1e-9, "a": torch.ones(4), "b": torch.ones(4)}
    g_prog = dict(g_ref, **{"kv_memory.key_conv.bias": torch.ones(4)})  # round-off alone
    p0 = {k: torch.zeros(4) for k in names}
    est = torch.zeros(2, 3, 2, 4, 4)
    est_prog = est.clone()
    est_prog[:, 1] += 0.01
    est_prog[:, 2] += 0.5  # frame 2 takes the program's own box decisions: not compared
    ref = ([1.0], g_ref, {k: torch.ones(4) for k in names}, est)
    prog = ([1.0], g_prog, {k: torch.ones(4) for k in names}, est_prog)
    n = D.compare(prog, ref, p0)
    assert n["read_grad_gap"] == 0.0 and n["still_leaves"] == 1
    assert abs(n["est_gap"] - 0.01) < 1e-9 and abs(D.est_gaps(est_prog, est)[1] - 0.5) < 1e-9
    assert D.est_gaps(est_prog[:1], est) == [float("inf")] * 2  # half the batch


def test_spread_note_quartiles_and_thirds():
    n = harness.spread_note([0.1, 0.2, 0.3, 0.4, 0.5, 0.6])
    assert n["n"] == 6 and n["min_ms"] == 100.0 and n["max_ms"] == 600.0
    assert np.allclose(n["thirds_mean_ms"], [150.0, 350.0, 550.0])
    assert abs(n["median_ms"] - 350.0) < 1e-9
