"""The port's modules and weight conversion against the JAX package (CPU, f32).

Weights come from ``rmnet_tpu.core.engine.build_models`` with randomised BN
running stats (so a mis-mapped BN cannot hide) and reach the port through
``from_jax_variables``. Tolerances are those of tests/test_model_parity.py:
1e-3 for the trunks and encoders, 2e-4 for KeyValue, Decoder and TinyFlowNet.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rmnet_tpu.config import Config
from rmnet_tpu.core.engine import build_models as jax_build_models
from rmnet_tpu.models.torch_import import import_state_dict

from rmnet_tpu_torch.models.rmnet import RMNet
from rmnet_tpu_torch.models.tiny_flownet import TinyFlowNet
from rmnet_tpu_torch.models.weights import (
    build_models,
    from_jax_variables,
    load_reference_checkpoint,
)

from tests import torch_ref as TR

torch.set_num_threads(2)

TRUNK_TOL = dict(rtol=1e-3, atol=1e-3)
HEAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _randomise_bn(tree, rs):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise_bn(v, rs)
        elif k == "running_mean":
            out[k] = rs.normal(0, 0.2, v.shape).astype(np.float32)
        else:
            out[k] = rs.uniform(0.8, 1.4, v.shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def nets():
    rmnet_j, tfn_j, rm_vars, tfn_vars = jax_build_models(Config(), 0)
    rm_vars = dict(rm_vars)
    rm_vars["batch_stats"] = _randomise_bn(rm_vars["batch_stats"], np.random.RandomState(0))
    rm_sd, tfn_sd = from_jax_variables(rm_vars, tfn_vars)
    rmnet, tfn = RMNet().eval(), TinyFlowNet().eval()
    rmnet.load_state_dict(rm_sd)
    tfn.load_state_dict(tfn_sd)
    return dict(rmnet_j=rmnet_j, tfn_j=tfn_j, rm_vars=rm_vars, tfn_vars=tfn_vars,
                rmnet=rmnet, tfn=tfn)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().permute(0, 2, 3, 1).numpy(), np.asarray(j), **tol)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_state_dict_names_are_the_reference_names():
    assert set(RMNet().state_dict()) == set(TR.RMNetT().state_dict())
    assert set(TinyFlowNet().state_dict()) == set(TR.TinyFlowNetT().state_dict())


def test_from_jax_variables_covers_every_tensor(nets):
    rm_sd, tfn_sd = from_jax_variables(nets["rm_vars"], nets["tfn_vars"])
    assert set(rm_sd) == set(RMNet().state_dict())
    assert set(tfn_sd) == set(TinyFlowNet().state_dict())
    # the randomised running stats arrived where the BN reads them
    bn = nets["rm_vars"]["batch_stats"]["encoder_memory"]["trunk"]["layer2_0"]["downsample_bn"]
    np.testing.assert_array_equal(
        nets["rmnet"].encoder_memory.res3[0].downsample[1].running_var.numpy(),
        bn["running_var"])


def test_encoder_query(nets):
    f = _rand(1, 48, 64, 3)
    j = nets["rmnet_j"].apply(nets["rm_vars"], jnp.asarray(f), method="encode_query")
    with torch.no_grad():
        r4, r3, r2 = nets["rmnet"].encoder_query(_nchw(f))
        k4, v4 = nets["rmnet"].kv_query(r4)
    jr4, jr3, jr2 = nets["rmnet_j"].apply(
        nets["rm_vars"], jnp.asarray(f), method=lambda m, x: m.encoder_query(x))
    for t, r in ((r4, jr4), (r3, jr3), (r2, jr2)):
        _close(t, r, TRUNK_TOL)
    _close(k4, j[0], TRUNK_TOL)
    _close(v4, j[1], TRUNK_TOL)


def test_encoder_memory_merged_stem(nets):
    f = _rand(1, 48, 64, 3, seed=1)
    rs = np.random.RandomState(2)
    m = rs.rand(2, 48, 64).astype(np.float32)
    o = rs.rand(2, 48, 64).astype(np.float32)
    jr4 = nets["rmnet_j"].apply(
        nets["rm_vars"], jnp.asarray(f), jnp.asarray(m), jnp.asarray(o),
        method=lambda mm, *a: mm.encoder_memory.shared(*a))
    with torch.no_grad():
        r4 = nets["rmnet"].encoder_memory.shared(_nchw(f), torch.from_numpy(m),
                                                 torch.from_numpy(o))
        # the merged 5-channel stem equals the three summed stems
        r4_sum = nets["rmnet"].encoder_memory(_nchw(f).expand(2, -1, -1, -1),
                                              torch.from_numpy(m), torch.from_numpy(o))
    _close(r4, jr4, TRUNK_TOL)
    np.testing.assert_allclose(r4.numpy(), r4_sum.numpy(), rtol=1e-4, atol=1e-4)


def test_keyvalue(nets):
    x = _rand(2, 5, 7, 1024, seed=3)
    jk, jv = nets["rmnet_j"].apply(nets["rm_vars"], jnp.asarray(x),
                                   method=lambda m, a: m.kv_memory(a))
    with torch.no_grad():
        k, v = nets["rmnet"].kv_memory(_nchw(x))
    _close(k, jk, HEAD_TOL)
    _close(v, jv, HEAD_TOL)


def test_decoder_skips_and_from_skips(nets):
    r4, r3, r2 = _rand(2, 3, 4, 1024, seed=4), _rand(2, 6, 8, 512, seed=5), \
        _rand(2, 12, 16, 256, seed=6)
    j = nets["rmnet_j"].apply(nets["rm_vars"], *(jnp.asarray(a) for a in (r4, r3, r2)),
                              method="decode")
    with torch.no_grad():
        dec = nets["rmnet"].decoder
        s3, s2 = dec.skips(_nchw(r3), _nchw(r2))
        out = dec.from_skips(_nchw(r4), s3, s2)
    assert out.shape == (2, 2, 48, 64)
    _close(out, j, HEAD_TOL)


def test_tiny_flownet_pair_forward(nets):
    img0, img1 = _rand(1, 48, 64, 3, seed=7), _rand(1, 48, 64, 3, seed=8)
    j = nets["tfn_j"].apply(nets["tfn_vars"], jnp.asarray(img0), jnp.asarray(img1),
                            method="pair_forward")
    with torch.no_grad():
        flow = nets["tfn"].pair_forward(_nchw(img0), _nchw(img1))
    assert flow.shape == (1, 2, 48, 64)
    _close(flow, j, HEAD_TOL)


def test_state_dict_round_trip_through_the_jax_importer(nets):
    """port state_dict -> rmnet_tpu import_state_dict -> the JAX variables,
    exactly."""
    for net, variables in ((nets["rmnet"], nets["rm_vars"]),
                           (nets["tfn"], nets["tfn_vars"])):
        back, missing = import_state_dict(variables, net.state_dict(), "reference")
        assert not missing
        flat_a = jax.tree_util.tree_leaves_with_path(variables)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf),
                                          err_msg=jax.tree_util.keystr(path))


def test_reference_checkpoint_loads(nets, tmp_path):
    rm_sd, tfn_sd = nets["rmnet"].state_dict(), nets["tfn"].state_dict()
    path = tmp_path / "ckpt-best.pth"
    torch.save({
        "epoch_index": 7,
        "best_metrics": {"JF-Mean": 0.5},
        "rmnet": {f"module.{k}": v for k, v in rm_sd.items()},
        "tflownet": {f"module.{k}": v for k, v in tfn_sd.items()},
    }, path)
    rm_ld, tfn_ld = load_reference_checkpoint(str(path))
    rmnet, tfn = RMNet(), TinyFlowNet()
    rmnet.load_state_dict(rm_ld)
    tfn.load_state_dict(tfn_ld)
    for k, v in rmnet.state_dict().items():
        assert torch.equal(v, rm_sd[k]), k
    for k, v in tfn.state_dict().items():
        assert torch.equal(v, tfn_sd[k]), k


def test_build_models_is_seeded():
    a, ta = build_models(seed=3, device="cpu")
    b, _ = build_models(seed=3, device="cpu")
    c, _ = build_models(seed=4, device="cpu")
    w = "decoder.pred2.weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    assert not a.training and not ta.training
    # kaiming-normal heads, torch-default trunks, zero head biases
    assert a.decoder.pred2.bias.abs().sum() == 0
    trunk = a.encoder_query.res2[0].conv1.weight
    assert trunk.abs().max() <= 1.0 / np.sqrt(trunk[0].numel())
