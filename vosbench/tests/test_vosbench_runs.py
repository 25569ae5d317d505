"""The drivers end to end at a tiny size on the CPU, against the reference:
a sound program comes out correct, and each fault planted underneath the
timed path comes out not correct. The chip check of run.py is skipped (the
drivers take the device); everything after it runs as in a cell's run."""

import dataclasses

import pytest
import torch

from vosbench import harness, manifest
from vosbench.reference import rmnet_ref

torch.set_num_threads(4)
SEED = 2 ** 31 + 123


def stream_cell(name="stream1-obj2-t48", frames=7, appear=None):
    cell = manifest.cell(name)
    cell.config = dict(cell.config, frame_height=64, frame_width=96, dtype="float32",
                       bbox_loose_pixels=6)
    cell.traffic = dict(cell.traffic, frames=frames, pool=2, sampled_videos=1,
                        appear=appear or cell.traffic["appear"])
    return cell


def train_cell():
    cell = manifest.cell("train-b4-t3")
    cell.config = dict(cell.config, batch_size=2, crop_height=64, crop_width=64)
    cell.traffic = dict(cell.traffic, pool=4, trace_after=1, traced_steps=1)
    return cell


def run(cell, trace=False):
    opt = harness.Options(seed=SEED, seconds=0.5, trace=trace, device="cpu")
    return manifest.driver(cell.driver).run(cell, opt)


def test_stream_sound_run_is_correct_and_reports_its_metrics():
    cell = stream_cell()
    r = run(cell, trace=True)
    assert r.correct, r.checks
    assert r.attempted >= 3 and r.failed == 0
    line = harness.result(cell, r, True)
    assert "graph_replays_per_video" in line["metrics"]
    assert list(line)[-1] == "checks" and set(line["checks"]) == set(cell.limits)


def test_stream_with_a_late_new_object_is_correct():
    assert run(stream_cell("stream1-obj5-t200", frames=9, appear=[0, 0, 0, 0, 5])).correct


def _frozen_step(monkeypatch):
    from rmnet_tpu_torch.models.rmnet import RMNetApply, VOSState

    real = RMNetApply.step

    def step(self, state, *args):
        scratch = VOSState(**{f.name: getattr(state, f.name).clone()
                              for f in dataclasses.fields(state)})
        _, est = real(self, scratch, *args)
        return state, est

    monkeypatch.setattr(RMNetApply, "step", step)


def _altered_answer(monkeypatch):
    from rmnet_tpu_torch.models.rmnet import RMNetApply

    real = RMNetApply._segment_frame

    def segment(self, *args, **kw):
        est, exist, bn = real(self, *args, **kw)
        return 0.9 * est + 0.1 / est.shape[1], exist, bn

    monkeypatch.setattr(RMNetApply, "_segment_frame", segment)


def _late_frames_altered(monkeypatch):
    from rmnet_tpu_torch.engine import InferenceEngine

    real = InferenceEngine.run_video

    def run_video(self, frames, masks, n_objects, flows=None):
        probs = real(self, frames, masks, n_objects, flows).copy()
        late = len(probs) // 2 + 1
        probs[late:] = 0.9 * probs[late:] + 0.1 / probs.shape[1]
        return probs

    monkeypatch.setattr(InferenceEngine, "run_video", run_video)


def _control_in_place(monkeypatch):
    """The reference computed in float8 e4m3, put in the program's place."""
    from rmnet_tpu_torch.engine import InferenceEngine

    def run_video(self, frames, masks, n_objects, flows=None):
        a = self.apply
        rm, tfn = rmnet_ref.on_device(*self._states, self.device, a.n_bbox_loose_pixels,
                                      a.n_pts_threshold, a.prob_threshold)
        with harness.no_tf32(), rmnet_ref.computed_in(rmnet_ref.fp8_e4m3, rm, tfn):
            return rmnet_ref.infer(rm, tfn, torch.from_numpy(frames).to(self.device),
                                   torch.from_numpy(masks).to(self.device), n_objects,
                                   self.memorize_every).cpu().numpy()

    real_init = InferenceEngine.__init__

    def init(self, cfg, rm_sd, tfn_sd, *args, **kw):
        real_init(self, cfg, rm_sd, tfn_sd, *args, **kw)
        self._states = (rm_sd, tfn_sd)

    monkeypatch.setattr(InferenceEngine, "__init__", init)
    monkeypatch.setattr(InferenceEngine, "run_video", run_video)


@pytest.mark.parametrize("fault", [_frozen_step, _altered_answer, _late_frames_altered,
                                   _control_in_place])
def test_stream_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = run(stream_cell())
    assert not r.correct, r.checks


def test_train_sound_run_is_correct_and_reports_its_metrics():
    cell = train_cell()
    r = run(cell, trace=True)
    assert r.correct, r.checks
    assert r.failed == 0 and r.counts["clips"] == 2 * r.attempted
    line = harness.result(cell, r, True)
    assert "step_mfu_pct.train" in line["metrics"]


def _half_batch(monkeypatch):
    from rmnet_tpu_torch.train import Trainer

    real = Trainer.train_step

    def train_step(self, batch, lr=None):
        B = batch["frames"].shape[0]
        return real(self, {k: v[:B // 2] for k, v in batch.items()}, lr)

    monkeypatch.setattr(Trainer, "train_step", train_step)


def _state_unchanged(monkeypatch):
    import rmnet_tpu_torch.train as train_mod

    real = train_mod.make_optimizer

    def make_optimizer(cfg, params):
        opt = real(cfg, params)
        opt.step = lambda *a, **k: None
        return opt

    monkeypatch.setattr(train_mod, "make_optimizer", make_optimizer)


def _loss_altered(monkeypatch):
    from rmnet_tpu_torch.train import Trainer

    real = Trainer.train_step
    monkeypatch.setattr(Trainer, "train_step", lambda self, b, lr=None: 1.02 * real(self, b, lr))


def _read_dq_wrong(monkeypatch):
    """The read's backward gives dQ x1.5 (its plain version off the card)."""
    import rmnet_tpu_torch.ops.flash_attention as fa

    real = fa.flash_read_bwd_reference

    def wrong(*args):
        dq, dk, dv = real(*args)
        return dq * 1.5, dk, dv

    monkeypatch.setattr(fa, "flash_read_bwd_reference", wrong)


@pytest.mark.parametrize("fault", [_half_batch, _state_unchanged, _loss_altered,
                                   _read_dq_wrong])
def test_train_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = run(train_cell())
    assert not r.correct, r.checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stream1-obj2-t48", "stream1-obj5-t200"])
def test_stream_control_at_the_cells_size_is_not_correct(monkeypatch, card, name):
    """On the card, at the cell's own sizes: the float8 control in the
    program's place comes out not correct."""
    _control_in_place(monkeypatch)
    cell = manifest.cell(name)
    cell.traffic = dict(cell.traffic, pool=1, sampled_videos=1)
    r = manifest.driver("stream").run(cell, harness.Options(seed=SEED, seconds=1.0,
                                                            trace=False, device=card))
    assert not r.correct, r.checks


@pytest.mark.gpu
def test_train_control_at_the_cells_size_is_not_correct(card):
    """On the card, at the cell's own sizes: the program's own TRAIN.BF16
    path, the control, comes out not correct."""
    cell = manifest.cell("train-b4-t3")
    cell.config = dict(cell.config, bf16=True)
    r = manifest.driver("train").run(cell, harness.Options(seed=SEED, seconds=1.0,
                                                           trace=False, device=card))
    assert not r.correct, r.checks
