"""The port's span and counter recorder (rmnet_tpu_torch/utils/profiling.py)
on the CPU: spans off and on, nesting, requests, the bound, the clock it
shares with torch.profiler, the device phases' host path, and the spans and
phases of the engine and the trainer, whose outputs must not change when
the recorder is on. Imports no JAX.
"""

import json
import time

import numpy as np
import pytest
import torch

from rmnet_tpu_torch.config import Config
from rmnet_tpu_torch.engine import InferenceEngine
from rmnet_tpu_torch.models.weights import build_models
from rmnet_tpu_torch.train import Trainer
from rmnet_tpu_torch.utils import profiling
from rmnet_tpu_torch.utils.profiling import MAX_PHASES, RECORDER, Recorder, trace_if

torch.set_num_threads(2)

ENGINE_PHASES = ("flow", "memorize", "query", "read", "decode")
TRAIN_SPANS = ("train.upload", "train.forward", "train.backward", "train.loss_read",
               "train.optimizer")


@pytest.fixture
def recorder():
    """The process's recorder, on and empty for the test, off and empty after."""
    RECORDER.clear()
    RECORDER.enable()
    yield RECORDER
    RECORDER.disable()
    RECORDER.clear()


@pytest.fixture(scope="module")
def states():
    rmnet, tfn = build_models(seed=0, device="cpu")
    return rmnet.state_dict(), tfn.state_dict()


# ------------------------------------------------------------------ spans
def test_off_returns_the_shared_noop_and_records_nothing():
    rec = Recorder()
    first, second = rec.span("a"), rec.span("b", req=3)
    assert first is second
    with first:
        rec.phase("flow", "cpu")
    assert rec.new_request() is None
    assert rec.drain() == [] and rec.totals() == {} and rec.phase_totals() == {}
    assert rec.dropped == 0


def test_nesting_parents_and_requests():
    rec = Recorder()
    rec.enable()
    req = rec.new_request()
    with rec.span("outer", req):
        with rec.span("inner"):
            with rec.span("leaf", req=req + 100):
                pass
        with rec.span("inner"):
            pass
    with rec.span("alone"):
        pass
    spans = rec.drain()
    assert [s.name for s in spans] == ["leaf", "inner", "inner", "outer", "alone"]
    by = {s.name: s for s in spans}
    assert by["outer"].parent is None and by["outer"].req == req
    assert by["inner"].parent == "outer" and by["inner"].req == req
    assert by["leaf"].parent == "inner" and by["leaf"].req == req + 100
    assert by["alone"].parent is None and by["alone"].req is None
    outer = by["outer"]
    assert all(outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
               for s in spans if s.name in ("inner", "leaf"))
    assert rec.new_request() != req
    assert rec.drain() == []  # drained
    assert rec.totals()["inner"][1] == 2  # totals outlive a drain


def test_bound_counts_dropped_spans_in_the_totals():
    rec = Recorder(max_spans=3)
    rec.enable()
    for _ in range(5):
        with rec.span("x"):
            pass
    assert len(rec.drain()) == 3 and rec.dropped == 2
    seconds, count = rec.totals()["x"]
    assert count == 5 and seconds >= 0
    rec.clear()
    assert rec.dropped == 0 and rec.totals() == {}


def test_totals_add_up_the_spans():
    rec = Recorder()
    rec.enable()
    for _ in range(3):
        with rec.span("sleep"):
            time.sleep(0.002)
    spans = rec.drain()
    seconds, count = rec.totals()["sleep"]
    assert count == 3 and seconds >= 0.006
    assert seconds == pytest.approx(sum(s.end_ns - s.start_ns for s in spans) * 1e-9)


def test_host_phases_charge_the_time_since_the_previous_stamp():
    rec = Recorder()
    rec.enable()
    for _ in range(2):
        rec.phase(None, "cpu")
        time.sleep(0.003)
        rec.phase("a", "cpu")
        rec.phase("b", torch.device("cpu"))
    totals = rec.phase_totals()
    assert totals["a"][1] == totals["b"][1] == 2
    assert totals["a"][0] >= 0.006 > totals["b"][0]
    rec.clear()
    assert rec.phase_totals() == {}
    for i in range(MAX_PHASES - 2):
        rec.phase(f"p{i}", "cpu")
    with pytest.raises(ValueError, match="phase names"):
        rec.phase("one too many", "cpu")


def test_spans_land_on_the_profilers_clock():
    """A span around an op, mapped by trace_start_offset, lies within 200 us
    of the op's own event on the profiler's timeline."""
    from torch.profiler import ProfilerActivity, profile

    rec = Recorder()
    rec.enable()
    x = torch.ones(1 << 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x.add_(1)
        with rec.span("around"):
            x.mul_(2)
    (s,) = rec.drain()
    (op,) = [e for e in prof.events() if e.name == "aten::mul_"]
    zero = profiling.trace_start_offset(prof)
    start_us, end_us = (s.start_ns - zero) / 1e3, (s.end_ns - zero) / 1e3
    assert abs(start_us - op.time_range.start) < 200
    assert abs(end_us - op.time_range.end) < 200


def test_trace_if_writes_the_blocks_spans_on_the_trace_clock(tmp_path):
    assert not RECORDER.on
    with trace_if(str(tmp_path)):
        assert RECORDER.on
        with profiling.span("engine.video", profiling.new_request()):
            torch.ones(1 << 16).mul_(2)
    assert not RECORDER.on
    RECORDER.clear()
    events = json.loads((tmp_path / "rmnet_trace.json").read_text())["traceEvents"]
    (s,) = [e for e in events if e.get("cat") == "rmnet_span"]
    (op,) = [e for e in events if e.get("name") == "aten::mul_"]
    assert s["name"] == "engine.video" and s["args"]["parent"] is None
    assert s["ts"] - 200 <= op["ts"] and op["ts"] + op["dur"] <= s["ts"] + s["dur"] + 200


# ----------------------------------------------------------------- engine
def _clip(T=6, H=48, W=64):
    rs = np.random.RandomState(0)
    frames = (rs.rand(T, H, W, 3).astype(np.float32) * 2 - 1)
    masks = np.zeros((T, 3, H, W), np.float32)
    masks[:, 0] = 1
    for k, (y, x) in enumerate(((8, 8), (24, 36)), start=1):
        masks[:, k, y:y + 16, x:x + 20] = 1
        masks[:, 0, y:y + 16, x:x + 20] = 0
    return frames, masks, np.full((T,), 2, np.int32)


def test_engine_spans_and_phases(states, recorder):
    """Probabilities bit-identical with the recorder on and off; one
    ``engine.replay`` per chunk program run; every engine span inside its
    video's ``engine.video`` and of its request; each device phase once a
    chunk step."""
    eng = InferenceEngine(Config(), *states, memorize_every=2, capacity=4, chunk=4,
                          device="cpu")
    clip = _clip()
    recorder.disable()
    off = eng.run_video(*clip)
    assert recorder.drain() == [] and recorder.phase_totals() == {}
    recorder.enable()
    replays0 = eng.replays
    on = [eng.run_video(*clip) for _ in range(2)]
    for probs in on:
        np.testing.assert_array_equal(probs, off)

    spans = recorder.drain()
    videos = [s for s in spans if s.name == "engine.video"]
    assert len(videos) == 2 and len({v.req for v in videos}) == 2
    assert all(v.parent is None for v in videos)
    replays = [s for s in spans if s.name == "engine.replay"]
    assert len(replays) == eng.replays - replays0 == 2 * len(eng._chunk_plan(5))
    for s in spans:
        assert s.name.startswith("engine.")
        if s.name == "engine.video":
            continue
        (video,) = [v for v in videos if v.req == s.req]
        assert s.parent == "engine.video"
        assert video.start_ns <= s.start_ns <= s.end_ns <= video.end_ns
    assert {s.name for s in spans} >= {"engine.prepare", "engine.stage", "engine.upload",
                                        "engine.replay", "engine.assemble"}
    steps = 2 * sum(eng._chunk_plan(5))
    phases = recorder.phase_totals()
    assert sorted(phases) == sorted(ENGINE_PHASES)
    assert all(n == steps for _, n in phases.values())


# ---------------------------------------------------------------- trainer
def _batch(B=1, T=3, H=32, W=32):
    rs = np.random.RandomState(1)
    masks = np.zeros((B, T, 3, H, W), np.float32)
    masks[:, :, 0] = 1
    masks[:, :, 1, 4:16, 4:20] = 1
    masks[:, 1:, 2, 18:28, 10:26] = 1
    masks[:, :, 0] -= masks[:, :, 1:].sum(axis=2)
    return dict(frames=rs.rand(B, T, H, W, 3).astype(np.float32) * 2 - 1, masks=masks,
                flows=rs.randn(B, T, H, W, 2).astype(np.float32),
                n_objects=np.array([[1] + [2] * (T - 1)] * B, np.int32))


def test_trainer_spans_and_phases(states, recorder):
    """Loss and parameters bit-identical with the recorder on and off; each
    ``train.*`` span once a step, of the step's request; the device phases
    once a step."""
    batch = _batch()
    runs = {}
    for on in (False, True):
        recorder.enable() if on else recorder.disable()
        trainer = Trainer(Config(), *states, device="cpu")
        losses = [trainer.train_step(batch) for _ in range(2)]
        runs[on] = losses, {k: v.clone() for k, v in trainer.rmnet.state_dict().items()}
    assert runs[True][0] == runs[False][0]
    for name, value in runs[False][1].items():
        assert torch.equal(runs[True][1][name], value), name

    spans = recorder.drain()
    assert sorted(s.name for s in spans) == sorted(TRAIN_SPANS * 2)
    reqs = {s.req for s in spans}
    assert len(reqs) == 2
    for req in reqs:
        assert sorted(s.name for s in spans if s.req == req) == sorted(TRAIN_SPANS)
    phases = recorder.phase_totals()
    assert sorted(phases) == ["train.backward", "train.forward"]
    assert all(n == 2 for _, n in phases.values())
