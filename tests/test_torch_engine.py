"""The port's InferenceEngine against the JAX package's, at f32 on the CPU.

Same weights (the port's seeded random init, imported into the JAX
package with ``rmnet_tpu.models.torch_import.import_state_dict``), same clip:
48x64, an object injected mid-clip, memorize_every=2 and a fixed capacity of
2, so the ring wraps. TinyFlowNet runs inside the frame loop in both. The
JAX engine reads densely on the CPU; the port runs both its reads (the
block-sparse one through the plain version of the kernel). Tolerance 5e-3,
the full-forward tolerance of tests/test_rmnet_forward.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rmnet_tpu.config import Config as JaxConfig
from rmnet_tpu.core.engine import InferenceEngine as JaxEngine
from rmnet_tpu.models.rmnet import RMNet as JaxRMNet
from rmnet_tpu.models.tiny_flownet import TinyFlowNet as JaxTinyFlowNet
from rmnet_tpu.models.torch_import import import_state_dict

from rmnet_tpu_torch.config import Config
from rmnet_tpu_torch.engine import InferenceEngine
from rmnet_tpu_torch.models.weights import build_models

from tests.test_rmnet_forward import LOOSE, build_clip

torch.set_num_threads(2)

MEMORIZE_EVERY = 2
CAPACITY = 2
OVERRIDES = {"n_bbox_loose_pixels": LOOSE}


def _clip():
    """build_clip (object 2 revealed at t=1) extended to T=6: four commits
    into a 2-slot ring."""
    frames, masks, _, n_objects = build_clip()
    rs = np.random.RandomState(1)
    extra = frames[:, -1:] + 0.1 * rs.randn(1, 3, *frames.shape[2:]).astype(np.float32)
    frames = np.concatenate([frames, extra], axis=1)[0]
    masks = np.concatenate([masks, np.repeat(masks[:, -1:], 3, axis=1)], axis=1)[0]
    n_objects = np.concatenate([n_objects[0], [2, 2, 2]])
    return frames, masks, n_objects


def _jax_variables(module, state_dict, *example):
    """JAX variables filled from a port state dict (shapes from eval_shape:
    no compile of the JAX init)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *example)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables, missing = import_state_dict(zeros, state_dict, "reference")
    assert not missing
    return variables


@pytest.fixture(scope="module")
def setup():
    rmnet, tfn = build_models(seed=0, device="cpu")
    states = (rmnet.state_dict(), tfn.state_dict())
    rm_vars = _jax_variables(JaxRMNet(), states[0], jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 32, 32)), jnp.zeros((1, 32, 32)))
    tfn_vars = _jax_variables(JaxTinyFlowNet(), states[1], jnp.zeros((1, 2, 64, 64, 3)))
    frames, masks, n_objects = _clip()
    jax_engine = JaxEngine(JaxConfig(), rm_vars, tfn_vars, memorize_every=MEMORIZE_EVERY,
                           capacity=CAPACITY, apply_overrides=OVERRIDES)
    expected = {
        "probs": jax_engine.run_video(frames, masks, n_objects),
        "labels": jax_engine.run_video_labels(frames, masks, n_objects),
    }
    return states, (frames, masks, n_objects), expected


@pytest.fixture(scope="module")
def engines(setup):
    states = setup[0]
    return {flash: InferenceEngine(Config(), *states, memorize_every=MEMORIZE_EVERY,
                                   capacity=CAPACITY, use_flash_attention=flash,
                                   device="cpu", apply_overrides=OVERRIDES)
            for flash in (True, False)}


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_run_video_matches_jax(setup, engines, flash):
    _, clip, expected = setup
    probs = engines[flash].run_video(*clip)
    assert probs.shape == expected["probs"].shape == (6, 4, 48, 64)
    np.testing.assert_allclose(probs, expected["probs"], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_run_video_labels_match_jax(setup, engines, flash):
    _, clip, expected = setup
    labels = engines[flash].run_video_labels(*clip)
    assert labels.dtype == np.uint8 and labels.shape == (6, 48, 64)
    np.testing.assert_array_equal(labels, expected["labels"])


def test_clip_wraps_the_ring(setup):
    _, (frames, masks, n_objects), _ = setup
    eng = InferenceEngine.__new__(InferenceEngine)
    eng.memorize_every = MEMORIZE_EVERY
    any_new, commit = eng._video_flags(n_objects, len(frames))
    assert any_new[1] and int(commit[:-1].sum()) > CAPACITY


def test_auto_capacity_buckets():
    """Auto capacity: the commit count in buckets of 8, or 32 with flash."""
    eng = InferenceEngine.__new__(InferenceEngine)
    eng.capacity = 0
    commit_short = np.array([True] * 4 + [False] * 16)
    commit_long = np.array([True] * 40 + [False] * 60)
    eng.use_flash_attention = True
    assert eng._capacity_for(20, commit_short) == 32
    assert eng._capacity_for(100, commit_long) == 64
    eng.use_flash_attention = False
    assert eng._capacity_for(20, commit_short) == 8
    assert eng._capacity_for(100, commit_long) == 40


def test_engine_defaults_to_the_card(setup):
    """device=None means CUDA; with no card the constructor raises rather
    than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    states, _, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(Config(), *states)
