"""The port's serving extras against the JAX package's, at f32 on the CPU:
run_video_raw (uint8 input, normalization and one-hot on the device),
compute_flows and multi_scale_inference (TTA).

Same weights (the port's seeded random init imported into the JAX package),
48x64 clips. Tolerances: 5e-3 on probabilities (the full-forward tolerance
of tests/test_rmnet_forward.py), 2e-4 on flows, labels equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rmnet_tpu.config import Config as JaxConfig
from rmnet_tpu.core.engine import InferenceEngine as JaxEngine
from rmnet_tpu.models.rmnet import RMNet as JaxRMNet
from rmnet_tpu.models.tiny_flownet import TinyFlowNet as JaxTinyFlowNet

from rmnet_tpu_torch.config import Config
from rmnet_tpu_torch.engine import GEOMETRIES_KEPT, InferenceEngine
from rmnet_tpu_torch.models.weights import build_models

from tests.test_engine_multistream import LOOSE
from tests.test_torch_engine import _clip, _jax_variables

torch.set_num_threads(2)

OVERRIDES = {"n_bbox_loose_pixels": LOOSE}
READS = pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
MEMORIZE_EVERY, CAPACITY, CHUNK = 2, 4, 4
SCALES = (1.0, 0.75)


def _configs():
    """(JAX, port) configs with the TTA of the test: two scales, the flip."""
    cfgs = JaxConfig(), Config()
    for cfg in cfgs:
        cfg.TEST.FRAME_SCALES, cfg.TEST.FLIP_LR = SCALES, True
    return cfgs


@pytest.fixture(scope="module")
def setup():
    rmnet, tfn = build_models(seed=0, device="cpu")
    states = (rmnet.state_dict(), tfn.state_dict())
    rm_vars = _jax_variables(JaxRMNet(), states[0], jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 32, 32)), jnp.zeros((1, 32, 32)))
    tfn_vars = _jax_variables(JaxTinyFlowNet(), states[1], jnp.zeros((1, 2, 64, 64, 3)))
    jax_engine = JaxEngine(_configs()[0], rm_vars, tfn_vars, memorize_every=MEMORIZE_EVERY,
                           capacity=CAPACITY, chunk=CHUNK, apply_overrides=OVERRIDES)
    return states, jax_engine


@pytest.fixture(scope="module")
def engines(setup):
    states = setup[0]
    return {flash: InferenceEngine(_configs()[1], *states, memorize_every=MEMORIZE_EVERY,
                                   capacity=CAPACITY, chunk=CHUNK, use_flash_attention=flash,
                                   device="cpu", apply_overrides=OVERRIDES)
            for flash in (True, False)}


def _raw_clip():
    """tests/test_engine_raw.py's clip (T=5, two objects), with an ignore
    (255) region in every label map."""
    T, H, W = 5, 48, 64
    rs = np.random.RandomState(0)
    frames_u8 = rs.randint(0, 255, (T, H, W, 3), np.uint8)
    labels = np.zeros((T, H, W), np.uint8)
    labels[:, 10:30, 8:28] = 1
    labels[:, 20:40, 40:60] = 2
    labels[:, 40:, :16] = 255
    return frames_u8, labels, np.full((T,), 2, np.int32)


@pytest.fixture(scope="module")
def raw_expected(setup):
    return setup[1].run_video_raw(*_raw_clip(), n_slots=3)


@READS
def test_run_video_raw_matches_jax(engines, raw_expected, flash):
    frames_u8, labels, n_objects = _raw_clip()
    got = engines[flash].run_video_raw(frames_u8, labels, n_objects, n_slots=3)
    assert got.dtype == np.uint8 and got.shape == (5, 48, 64)
    np.testing.assert_array_equal(got[0], np.where(labels[0] == 255, 0, labels[0]))
    np.testing.assert_array_equal(got, raw_expected)


@READS
def test_run_video_raw_matches_the_float_path(engines, flash):
    """The uint8 path against run_video_labels on the host-normalized frames
    and one-hot masks (the ignore label one-hot to zeros): within
    tests/test_engine_raw.py's 2e-3 mismatch budget (host and in-graph
    normalization may differ by an ulp)."""
    frames_u8, labels, n_objects = _raw_clip()
    cst = Config().CONST
    frames = (frames_u8.astype(np.float32) / 255.0 - np.asarray(cst.DATASET_MEAN, np.float32)) \
        / np.asarray(cst.DATASET_STD, np.float32)
    masks = np.stack([labels == k for k in range(3)], 1).astype(np.float32)
    eng = engines[flash]
    mismatch = np.mean(eng.run_video_raw(frames_u8, labels, n_objects, n_slots=3)
                       != eng.run_video_labels(frames, masks, n_objects))
    assert mismatch < 2e-3


@pytest.fixture(scope="module")
def frames():
    return _clip()[0]


def test_compute_flows_matches_jax(setup, engines, frames):
    """TinyFlowNet flows in batches of 2 pairs (the last one padded)."""
    expected = setup[1].compute_flows(frames, chunk=2)
    got = engines[True].compute_flows(frames, chunk=2)
    assert got.shape == expected.shape == (6, 48, 64, 2)
    assert not got[0].any()
    np.testing.assert_allclose(got, expected, rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def tta_expected(setup):
    return setup[1].multi_scale_inference(*_clip())


@READS
def test_multi_scale_inference_matches_jax(engines, tta_expected, flash):
    """Scales 1.0 and 0.75, each with the flip: four passes summed on the
    device, against the JAX engine's TTA."""
    flows, probs = engines[flash].multi_scale_inference(*_clip())
    ref_flows, ref_probs = tta_expected
    assert probs.shape == ref_probs.shape == (6, 4, 48, 64)
    assert flows.shape == ref_flows.shape == (6, 48, 64, 2)
    np.testing.assert_allclose(flows, ref_flows, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(probs, ref_probs, rtol=5e-3, atol=5e-3)


def test_tta_config_defaults():
    test = Config().TEST
    assert test.FRAME_SCALES == JaxConfig().TEST.FRAME_SCALES == (1.0,)
    assert test.FLIP_LR is JaxConfig().TEST.FLIP_LR is False


def test_engine_keeps_the_latest_geometries(setup):
    """Three frame sizes in turn: the engine keeps the state and chunk
    programs of the GEOMETRIES_KEPT latest, and a size run again after its
    eviction gives the same probabilities."""
    eng = InferenceEngine(Config(), *setup[0], memorize_every=MEMORIZE_EVERY,
                          capacity=CAPACITY, chunk=CHUNK, device="cpu")
    frames, masks, n_objects = _clip()
    widths = (64, 48, 32)
    first = {W: eng.run_video(frames[:, :, :W], masks[..., :W], n_objects) for W in widths}
    assert GEOMETRIES_KEPT == 2
    assert [g[2] for g in eng._geometries] == [48, 32]
    again = eng.run_video(frames[:, :, :64], masks[..., :64], n_objects)
    assert [g[2] for g in eng._geometries] == [32, 64]
    np.testing.assert_array_equal(again, first[64])
    assert all(programs for _, _, programs in eng._geometries.values())
