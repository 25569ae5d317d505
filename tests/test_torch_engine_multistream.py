"""The port's device-side step, chunk_forward and multi-stream serving against
the JAX package's, at f32 on the CPU.

Same weights (the port's seeded random init, imported into the JAX package
with ``import_state_dict``), 48x64 clips of tests/test_engine_multistream.py
(flows given). The JAX package reads densely on the CPU; the port runs both
its reads (the block-sparse one through the plain version of the kernel).
Tolerances: 5e-3 on probabilities against JAX (the full-forward tolerance of
tests/test_rmnet_forward.py), 1e-4 between the port's batched and
single-video runs (tests/test_engine_multistream.py's), labels equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rmnet_tpu.config import Config as JaxConfig
from rmnet_tpu.core.engine import InferenceEngine as JaxEngine
from rmnet_tpu.models.rmnet import RMNet as JaxRMNet
from rmnet_tpu.models.tiny_flownet import TinyFlowNet as JaxTinyFlowNet

from rmnet_tpu_torch.config import Config
from rmnet_tpu_torch.engine import InferenceEngine
from rmnet_tpu_torch.models.weights import build_models

from tests.test_engine_multistream import LOOSE, _make_video, _make_video_schedule
from tests.test_torch_engine import _jax_variables

torch.set_num_threads(2)

OVERRIDES = {"n_bbox_loose_pixels": LOOSE}
READS = pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
# (memorize_every, capacity) per engine kind; "wrap" commits every frame into 2 slots
KINDS = {"main": (2, 4), "wrap": (1, 2)}


@pytest.fixture(scope="module")
def weights():
    rmnet, tfn = build_models(seed=0, device="cpu")
    states = (rmnet.state_dict(), tfn.state_dict())
    rm_vars = _jax_variables(JaxRMNet(), states[0], jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 32, 32)), jnp.zeros((1, 32, 32)))
    tfn_vars = _jax_variables(JaxTinyFlowNet(), states[1], jnp.zeros((1, 2, 64, 64, 3)))
    return states, rm_vars, tfn_vars


@pytest.fixture(scope="module")
def jax_engines(weights):
    _, rm_vars, tfn_vars = weights
    return {kind: JaxEngine(JaxConfig(), rm_vars, tfn_vars, memorize_every=m, capacity=c,
                            apply_overrides=OVERRIDES)
            for kind, (m, c) in KINDS.items()}


@pytest.fixture(scope="module")
def engines(weights):
    states = weights[0]
    return {(kind, flash): InferenceEngine(Config(), *states, memorize_every=m, capacity=c,
                                           use_flash_attention=flash, device="cpu",
                                           apply_overrides=OVERRIDES)
            for kind, (m, c) in KINDS.items() for flash in (True, False)}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


# ------------------------------------------------------------------- step
# three steps of two streams: stream 0 commits every step (three commits into
# two slots: the ring wraps), stream 1 only at the second; new objects are
# revealed at step 1 in stream 0 only
STEP_COMMIT = np.array([[True, False], [True, True], [True, False]])
STEP_ANY_NEW = np.array([[True, False], [False, False], [False, True]])


def _step_inputs():
    vids = [_make_video_schedule(0, 8, appear_t=1), _make_video_schedule(1, 14, appear_t=3)]
    frames, masks, n_objects, flows = (np.stack(x) for x in zip(*vids))
    K = masks.shape[2]
    obj_valid = (np.arange(K)[None] >= 1) & (np.arange(K)[None] <= n_objects.max(1)[:, None])
    return frames, masks, flows, obj_valid


@pytest.fixture(scope="module")
def jax_steps(weights, jax_engines):
    """The JAX per-stream step over STEP_*: est per step and the last state."""
    _, rm_vars, _ = weights
    apply = jax_engines["wrap"].apply
    frames, masks, flows, obj_valid = _step_inputs()
    state = apply.init_state(jnp.asarray(frames[:, 0]), jnp.asarray(masks[:, 0]), capacity=2,
                             per_stream_cursor=True)
    step = jax.jit(lambda s, f, fl, g, a, c: apply.step(rm_vars, s, f, fl, g, a, c,
                                                        jnp.asarray(obj_valid))[:2])
    ests = []
    for t in range(1, 4):
        state, est = step(state, frames[:, t], flows[:, t], masks[:, t],
                          STEP_ANY_NEW[t - 1], STEP_COMMIT[t - 1])
        ests.append(np.asarray(est))
    return ests, jax.tree_util.tree_map(np.asarray, state)


@READS
def test_step_matches_jax_per_stream(engines, jax_steps, flash):
    """Per-stream cursors and flags on the device: one stream commits where
    the other does not, new objects in one stream only, a ring wrap."""
    expected, jax_state = jax_steps
    apply = engines[("wrap", flash)].apply
    frames, masks, flows, obj_valid = _step_inputs()
    with torch.inference_mode():
        state = apply.init_state(_nchw(frames[:, 0]), torch.from_numpy(masks[:, 0]), 2)
        for t in range(1, 4):
            state, est = apply.step(
                state, _nchw(frames[:, t]), _nchw(flows[:, t]), torch.from_numpy(masks[:, t]),
                torch.from_numpy(STEP_ANY_NEW[t - 1]), torch.from_numpy(STEP_COMMIT[t - 1]),
                torch.from_numpy(obj_valid))
            np.testing.assert_allclose(est.numpy(), expected[t - 1], rtol=5e-3, atol=5e-3,
                                       err_msg=f"step {t}")
    np.testing.assert_array_equal(state.cursor.numpy(), jax_state.bank.cursor)
    np.testing.assert_array_equal(state.cursor.numpy(), STEP_COMMIT.sum(0))
    np.testing.assert_array_equal(state.exist.numpy(), jax_state.exist)
    # the ring slots (the ephemeral slot is the port's own)
    np.testing.assert_array_equal(state.bboxes[:, :, :2].numpy(), jax_state.bank.bboxes)
    np.testing.assert_allclose(state.keys[:, :, :2].numpy(), jax_state.bank.keys,
                               rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------- chunk_forward
# two chunks of two steps; stream 1 ends after the first chunk, and its
# padded steps would commit and reveal objects if they were not padding
CHUNK_VALID = np.array([[[True, True], [True, True]], [[True, False], [True, False]]])
CHUNK_COMMIT = np.array([[[True, True], [False, True]], [[True, True], [True, True]]])
CHUNK_ANY_NEW = np.array([[[True, False], [False, False]], [[False, True], [False, True]]])


def _chunk_inputs():
    vids = [_make_video_schedule(0, 8, appear_t=1, T_i=5),
            _make_video_schedule(1, 14, appear_t=3, T_i=5)]
    frames, masks, n_objects, _ = (np.stack(x) for x in zip(*vids))
    K = masks.shape[2]
    obj_valid = (np.arange(K)[None] >= 1) & (np.arange(K)[None] <= n_objects.max(1)[:, None])
    return frames, masks, obj_valid


@pytest.fixture(scope="module")
def jax_chunks(weights, jax_engines):
    """JAX chunk_forward over the two chunks, TinyFlowNet in the scan -> est
    (4, 2, K, H, W)."""
    _, rm_vars, tfn_vars = weights
    eng = jax_engines["main"]
    frames, masks, obj_valid = _chunk_inputs()
    state = eng.apply.init_state(jnp.asarray(frames[:, 0]), jnp.asarray(masks[:, 0]),
                                 capacity=4, per_stream_cursor=True)

    def tfn(curr, prev):
        return eng.tflownet.apply(tfn_vars, curr, prev, method="pair_forward")

    chunk = jax.jit(lambda s, f, g, a, c, v: eng.apply.chunk_forward(
        rm_vars, tfn, s, f, g, a, c, v, jnp.asarray(obj_valid)))
    ests = []
    for i in range(2):
        steps = slice(1 + 2 * i, 3 + 2 * i)
        state, est = chunk(state, np.moveaxis(frames[:, steps], 0, 1),
                           np.moveaxis(masks[:, steps], 0, 1), CHUNK_ANY_NEW[i],
                           CHUNK_COMMIT[i], CHUNK_VALID[i])
        ests.append(np.asarray(est))
    return np.concatenate(ests)


def _snapshot(state):
    return {f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)}


@READS
def test_chunk_forward_matches_jax(engines, jax_chunks, flash):
    """Two chunks through the port's chunk_forward (TinyFlowNet from the
    carried previous frame) against JAX on every live step; the padded
    steps leave the stopped stream's state bit-identical."""
    eng = engines[("main", flash)]
    frames, masks, obj_valid = _chunk_inputs()
    ests = []
    with torch.inference_mode():
        state = eng.apply.init_state(_nchw(frames[:, 0]), torch.from_numpy(masks[:, 0]), 4)
        for i in range(2):
            if i == 1:
                before = _snapshot(state)
            steps = slice(1 + 2 * i, 3 + 2 * i)
            est = eng.apply.chunk_forward(
                eng.tflownet.pair_forward, state, _nchw(frames[:, steps]).transpose(0, 1),
                torch.from_numpy(masks[:, steps]).transpose(0, 1),
                *(torch.from_numpy(a[i]) for a in (CHUNK_ANY_NEW, CHUNK_COMMIT, CHUNK_VALID)),
                torch.from_numpy(obj_valid))
            ests.append(est.numpy())
    est = np.concatenate(ests)
    assert est.shape == jax_chunks.shape == (4, 2, 4, 48, 64)
    live = np.concatenate(CHUNK_VALID)
    np.testing.assert_allclose(est[live], jax_chunks[live], rtol=5e-3, atol=5e-3)
    for name, old in before.items():
        new = getattr(state, name)
        if name in ("keys", "values", "bboxes"):
            # the ring slots; the ephemeral slot is rewritten at every step
            new, old = new[:, :, :-1], old[:, :, :-1]
        assert torch.equal(new[1], old[1]), f"{name} of the stopped stream changed"
        assert not torch.equal(new[0], old[0]) or name == "exist", f"{name} of stream 0 froze"


# ----------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def lockstep(jax_engines):
    vids = [_make_video(0, 8), _make_video(1, 14)]
    frames, masks, flows, n_objects = (np.stack(x) for x in zip(*vids))
    clip = (frames, masks, n_objects, flows)
    eng = jax_engines["main"]
    return clip, eng.run_videos(*clip), eng.run_videos_labels(*clip)


@READS
def test_run_videos_match_jax(engines, lockstep, flash):
    """Lockstep N = 2 (equal flags) against the JAX engine, probabilities
    and labels."""
    clip, probs, labels = lockstep
    eng = engines[("main", flash)]
    got = eng.run_videos(*clip)
    assert got.shape == probs.shape == (2, 4, 4, 48, 64)
    np.testing.assert_allclose(got, probs, rtol=5e-3, atol=5e-3)
    got_labels = eng.run_videos_labels(*clip)
    assert got_labels.dtype == np.uint8
    np.testing.assert_array_equal(got_labels, labels)


# (engine kind, [(seed, x0, second object's frame, length)])
BATCHES = {
    "mixed": ("main", [(0, 8, 1, 4), (1, 14, 2, 4), (2, 20, 99, 4)]),
    "ragged": ("main", [(0, 8, 1, 6), (1, 14, 1, 4), (2, 20, 2, 3)]),
    "wrap": ("wrap", [(0, 8, 1, 6), (1, 14, 3, 5)]),
}


@pytest.fixture(scope="module")
def batches(jax_engines):
    out = {}
    for name, (kind, spec) in BATCHES.items():
        vids = [_make_video_schedule(s, x0, appear_t=a, T_i=n) for s, x0, a, n in spec]
        probs = jax_engines[kind].run_video_batch(vids, return_probs=True)
        labels = (jax_engines[kind].run_video_batch(vids, return_probs=False)
                  if name == "mixed" else None)
        out[name] = (kind, vids, probs, labels)
    return out


@READS
@pytest.mark.parametrize("name", list(BATCHES))
def test_run_video_batch_matches_jax_and_single_videos(engines, batches, flash, name):
    """Ragged serving (mixed schedules, ragged lengths, a per-stream ring
    wrap at capacity 2): each video against JAX's run_video_batch and
    against the video served alone by the port."""
    kind, vids, expected, expected_labels = batches[name]
    eng = engines[(kind, flash)]
    got = eng.run_video_batch(vids, return_probs=True)
    assert len(got) == len(vids)
    for i, (est, ref, vid) in enumerate(zip(got, expected, vids)):
        single = eng.run_video(vid[0], vid[1], vid[2], flows=vid[3])
        assert est.shape == ref.shape == single.shape, f"video {i}"
        np.testing.assert_allclose(est, ref, rtol=5e-3, atol=5e-3, err_msg=f"video {i}")
        np.testing.assert_allclose(est, single, rtol=1e-4, atol=1e-4, err_msg=f"video {i}")
    if expected_labels is not None:
        labels = eng.run_video_batch(vids)
        for i, (lab, ref) in enumerate(zip(labels, expected_labels)):
            np.testing.assert_array_equal(lab, ref, err_msg=f"video {i}")


def test_run_video_batch_rejects_mixed_inputs(engines):
    eng = engines[("main", True)]
    a = _make_video_schedule(0, 8, appear_t=1)
    b = _make_video_schedule(1, 14, appear_t=1)
    with pytest.raises(ValueError, match="flows"):
        eng.run_video_batch([a, b[:3]])
    small = (b[0][:, :32], b[1][:, :, :32], b[2], b[3][:, :32])
    with pytest.raises(ValueError, match="frame size"):
        eng.run_video_batch([a, small])


def test_chunk_plan_matches_jax():
    port, ref = InferenceEngine.__new__(InferenceEngine), JaxEngine.__new__(JaxEngine)
    for chunk in (1, 2, 4, 8, 16):
        port.chunk = ref.chunk = chunk
        for n in range(1, 50):
            assert port._chunk_plan(n) == ref._chunk_plan(n), (chunk, n)
