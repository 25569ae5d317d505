"""The yardstick's arithmetic against brute counts: the read's in-box work
and least time, the window's rate and tail, the traced window's busy time
and idle gaps, and the seeded sample."""

import math

import numpy as np
import pytest
import torch

from vosbench import harness, manifest, trace, work


def _read_case(seed=0, N=3, S=5, h=6, w=9, Ck=128, Cv=512, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    m_key = torch.randn(N, S, h, w, Ck, generator=g).to(dtype)
    m_val = torch.randn(N, S, h, w, Cv, generator=g).to(dtype)
    q_key = torch.randn(N, h, w, Ck, generator=g).to(dtype)
    slot_valid = torch.rand(N, S, generator=g) > 0.3
    lo = torch.randint(0, 16 * w, (N, S, 2), generator=g)
    hi = lo + torch.randint(0, 16 * w, (N, S, 2), generator=g)
    bboxes = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1).int()
    return m_key, m_val, q_key, slot_valid, bboxes


def test_inbox_positions_match_a_brute_count():
    m_key, m_val, q_key, slot_valid, bboxes = _read_case()
    N, S, h, w = m_key.shape[:4]
    want = 0
    for n in range(N):
        for s in range(S):
            x0, x1, y0, y1 = bboxes[n, s].tolist()
            if slot_valid[n, s]:
                want += sum(y0 <= 16 * i <= y1 and x0 <= 16 * j <= x1
                            for i in range(h) for j in range(w))
    assert int(work.inbox_positions(m_key, q_key, slot_valid, bboxes)) == want


def test_read_least_time_by_hand():
    m_key, m_val, q_key, slot_valid, bboxes = _read_case(dtype=torch.bfloat16)
    inbox = int(work.inbox_positions(m_key, q_key, slot_valid, bboxes))
    ff, fb, bf, bb = work.read_terms(m_key, m_val, q_key, inbox)
    N, Q = 3, 6 * 9
    assert ff == 2 * Q * inbox * 640
    assert fb == (inbox * 640 + N * Q * 640) * 2 + N * Q * 4
    assert bf == 2 * Q * inbox * (3 * 128 + 2 * 512)
    assert bb == (2 * inbox * 640 + N * Q * (2 * 128 + 512)) * 2 + 2 * N * Q * 4
    assert work.least_seconds(ff, fb, torch.bfloat16) == max(ff / 989e12, fb / 3.35e12)
    assert work.least_seconds(ff, fb, torch.float32) == max(ff / 495e12, fb / 3.35e12)


def test_read_work_counts_each_call_and_leaves_it_unchanged():
    case = _read_case()

    class Module:
        @staticmethod
        def flash_memory_read(*args):
            return "result"

    with work.ReadWork(Module, "cpu") as counted:
        assert Module.flash_memory_read(*case) == "result"
        assert Module.flash_memory_read(*case) == "result"
        got = counted.read()
    inbox = int(work.inbox_positions(case[0], case[2], case[3], case[4]))
    ff, fb, bf, bb = work.read_terms(case[0], case[1], case[2], inbox)
    assert got["calls"] == 2
    assert math.isclose(got["fwd_bound_s"], 2 * work.least_seconds(ff, fb, torch.float32))
    assert math.isclose(got["bwd_bound_s"], 2 * work.least_seconds(bf, bb, torch.float32))
    assert Module.flash_memory_read(*case) == "result"  # restored


def test_model_flops_by_hand():
    # one 3x3 conv, 1024 -> 128 channels, on the /16 grid of 480x864
    f = work._conv_flops(torch.nn.Conv2d(1024, 128, 3, padding=1), work._meta(1, 1024, 30, 54))
    assert sum(f.values()) == 2 * 30 * 54 * 128 * 1024 * 9
    commit = work.commits(12, 5, [0, 7])
    assert [t for t, c in enumerate(commit) if c] == [0, 5, 7, 10]
    per = work.read_flops(480, 854, 2, 1)
    assert per == 2 * 2 * 1620 * 1620 * 640


def _run(**kw):
    base = dict(kind="stream", setup_s=1.0, window_s=10.0, attempted=4, failed=0,
                counts=dict(videos=4, frames=4 * 47, replays=36), walls=[2.0, 2.5, 2.5, 3.0],
                peak_bytes_window=3 * 2 ** 30, peak_bytes_process=4 * 2 ** 30, checks={},
                correct=True, device={})
    base.update(kw)
    return harness.Run(**base)


def _reader(name):
    return manifest.load_metric({"name": name, "unit": "x"}, "end_to_end").reader


def test_window_rate_and_tail_take_all_work_over_all_time():
    run = _run()
    assert _reader("frames_per_s")(run) == 4 * 47 / 10.0
    assert _reader("video_ms_p90")(run) == pytest.approx(np.percentile([2.0, 2.5, 2.5, 3.0], 90)
                                                         * 1e3)
    assert _reader("peak_mem_gib")(run) == 3.0
    assert _reader("clips_per_s")(run) is None  # not a training run
    train = _run(kind="train", counts=dict(steps=10, clips=40))
    assert _reader("clips_per_s")(train) == 4.0


def test_traced_window_busy_time_and_gaps():
    host = [(trace.ROOT_RANGE, 0.0, 100.0), ("outer", 0.0, 100.0),
            ("cudaStreamSynchronize", 40.0, 60.0)]
    device = [("k_conv", 10.0, 30.0), ("flash_read_fwd_bf16_kernel", 25.0, 40.0),
              ("Memcpy HtoD", 60.0, 70.0), ("late", 95.0, 120.0), (trace.ROOT_RANGE, 0, 100)]
    s = trace.summarize(device, host)
    assert s.span_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((40 - 10 + 10 + 5) * 1e-6)
    assert s.sum_matching("flash_read_fwd") == pytest.approx(15e-6)
    assert dict(s.buckets())["flash read kernel"] == pytest.approx(15e-6)
    # idle: 0-10 (outer), 40-60 (sync), 70-95 (outer); longest first
    assert [n for n, _ in s.gaps] == ["outer", "cudaStreamSynchronize", "outer"]
    assert [g for _, g in s.gaps] == pytest.approx([25e-6, 20e-6, 10e-6])
    assert trace.summarize(device, host[1:]) is None


def test_roofline_and_idle_readers():
    s = trace.Summary(span_s=2.0, busy_s=1.5, kernel_s={"flash_read_fwd_bf16_kernel": 0.1},
                      gaps=[], units=50)
    run = _run(trace=s, read_work=dict(fwd_bound_s=0.02, bwd_bound_s=0.0, calls=50))
    per = {m: manifest.load_metric({"name": m, "unit": "x"}, "per_layer").reader for m in (
        "read_fwd_roofline_pct", "read_fwd_ms_per_frame", "device_idle_pct.stream",
        "device_ms_per_frame", "read_bwd_roofline_pct")}
    assert per["read_fwd_roofline_pct"](run) == pytest.approx(20.0)
    assert per["read_fwd_ms_per_frame"](run) == pytest.approx(2.0)
    assert per["device_idle_pct.stream"](run) == pytest.approx(25.0)
    assert per["device_ms_per_frame"](run) == pytest.approx(30.0)
    assert per["read_bwd_roofline_pct"](run) is None  # nothing to read: never 0
    assert per["read_fwd_roofline_pct"](_run()) is None


def test_reservoir_is_seeded_and_uniform():
    def picks(seed, n, k=2):
        r = harness.Reservoir(seed, k)
        for i in range(n):
            r.offer(i)
        return sorted(r.items)

    assert picks(2 ** 31 + 7, 50) == picks(2 ** 31 + 7, 50)
    counts = np.zeros(20)
    for seed in range(2000):
        for i in picks(seed, 20):
            counts[i] += 1
    assert counts.min() > 0.7 * counts.mean() and counts.max() < 1.3 * counts.mean()


def test_checks_judge_every_number():
    assert harness.judge({"a": (0.1, 0.2), "b": (0.0, 0.0)})
    assert not harness.judge({"a": (0.3, 0.2)})
    assert not harness.judge({"a": (float("nan"), 0.2)})
    assert not harness.judge({"a": (0.1, None)})
