"""The port's ops against rmnet_tpu.ops on the same numpy inputs (CPU, f32).

Float ops at rtol/atol 1e-5; the box ops (integers and a binary raster)
exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rmnet_tpu.models.rmnet import _present_objects as jax_present_objects
from rmnet_tpu.models.rmnet import memory_read as jax_memory_read
from rmnet_tpu.ops import aggregation as jax_agg
from rmnet_tpu.ops import att_map as jax_att
from rmnet_tpu.ops import pad as jax_pad
from rmnet_tpu.ops import resize as jax_resize
from rmnet_tpu.ops import warp as jax_warp

from rmnet_tpu_torch.models.rmnet import _present_objects, memory_read
from rmnet_tpu_torch.ops import aggregation, att_map, pad, resize, warp

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape,axes", [
    ((2, 37, 50, 3), (-3, -2)),
    ((1, 3, 45, 61), (-2, -1)),
    ((2, 48, 64, 5), (-3, -2)),
])
def test_pad_unpad(shape, axes):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    for d in (16, 64):
        (pj,), pads_j = jax_pad.pad_divide_by([jnp.asarray(x)], d, spatial_axes=axes)
        (pt,), pads_t = pad.pad_divide_by([_t(x)], d, spatial_axes=axes)
        assert pads_t == tuple(pads_j) == jax_pad.divide_pads(
            shape[axes[0]], shape[axes[1]], d)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(
            pad.unpad(pt, pads_t, spatial_axes=axes).numpy(), x)


@pytest.mark.parametrize("out_hw", [(24, 32), (96, 128), (35, 21), (50, 70)])
def test_resize_bilinear(out_hw):
    x = np.random.RandomState(1).randn(2, 48, 64, 3).astype(np.float32)
    j = jax_resize.resize_bilinear(jnp.asarray(x), out_hw, align_corners=False)
    t = resize.resize_bilinear(_t(x), out_hw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    xc = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    jc = jax_resize.resize_bilinear(jnp.asarray(xc), out_hw, spatial_axes=(-2, -1))
    tc = resize.resize_bilinear(_t(xc), out_hw, spatial_axes=(-2, -1))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


@pytest.mark.parametrize("out_hw", [(3, 4), (96, 128), (30, 41)])
def test_resize_nearest(out_hw):
    x = np.random.RandomState(2).rand(1, 4, 48, 64).astype(np.float32)
    j = jax_resize.resize_nearest(jnp.asarray(x), out_hw, spatial_axes=(-2, -1))
    t = resize.resize_nearest(_t(x), out_hw, spatial_axes=(-2, -1))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    assert resize.scale_hw(45, 61, 0.5) == jax_resize.scale_hw(45, 61, 0.5)


@pytest.mark.parametrize("scale", [0.5, 3.0, 20.0])
def test_backward_warp(scale):
    """Flows up to 20 px push many samples off the 48x64 frame, so the 0.9999
    validity cut decides a wide border."""
    rs = np.random.RandomState(3)
    img = rs.rand(2, 48, 64, 3).astype(np.float32)
    flow = (rs.randn(2, 48, 64, 2) * scale).astype(np.float32)
    flow[0, :4] = np.round(flow[0, :4])  # integer flows: taps exactly on pixels
    wj, mj = jax_warp.backward_warp(jnp.asarray(img), jnp.asarray(flow))
    wt, mt = warp.backward_warp(_t(img), _t(flow))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert 0.05 < 1 - mt.numpy().mean() < 0.95 or scale < 1
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TOL)
    # channel-less form
    wj2, _ = jax_warp.backward_warp(jnp.asarray(img[..., 0]), jnp.asarray(flow))
    wt2, _ = warp.backward_warp(_t(img[..., 0]), _t(flow))
    np.testing.assert_allclose(wt2.numpy(), np.asarray(wj2), **TOL)


def test_soft_aggregation():
    rs = np.random.RandomState(4)
    ps = rs.rand(2, 4, 16, 20).astype(np.float32)
    ps[0, 1, :2] = 1.0  # clamp at 1 - 1e-7
    ps[1, 2, :2] = 0.0  # clamp at 1e-7
    valid = np.array([[False, True, True, False], [False, True, True, True]])
    j = jax_agg.soft_aggregation(jnp.asarray(ps), jnp.asarray(valid))
    t = aggregation.soft_aggregation(_t(ps), _t(valid))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_present_objects():
    rs = np.random.RandomState(5)
    labels = rs.randint(0, 3, (3, 16, 20))
    labels[1] = 1        # background absent
    labels[2, :, :] = 0  # only background
    one_hot = np.stack([(labels == k) for k in range(4)], 1).astype(np.float32)
    one_hot[0, :, :2] = 0  # all-zero (ignored) pixels count as background
    j = jax_present_objects(jnp.asarray(one_hot))
    t = _present_objects(_t(one_hot))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_dense_memory_read():
    rs = np.random.RandomState(6)
    N, S, h, w, Ck, Cv = 3, 4, 5, 6, 128, 64
    mk = rs.randn(N, S, h, w, Ck).astype(np.float32)
    mv = rs.randn(N, S, h, w, Cv).astype(np.float32)
    qk = rs.randn(N, h, w, Ck).astype(np.float32)
    qv = rs.randn(N, h, w, Cv).astype(np.float32)
    valid = np.array([[True, True, False, True], [True, False, False, False],
                      [True, True, True, True]])
    oj, pj = jax_memory_read(*(jnp.asarray(a) for a in (mk, mv, qk, qv, valid)))
    ot, pt = memory_read(*(_t(a) for a in (mk, mv, qk, qv, valid)))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)


def _box_masks():
    """(B, K, H, W) masks covering the box op's edge cases."""
    B, K, H, W = 2, 5, 48, 64
    m = np.zeros((B, K, H, W), np.float32)
    m[:, 0] = 1.0                     # slot 0: background, zero box regardless
    m[0, 1, 20:24, 30:34] = 0.9       # 16 points, box dilated inside the frame
    m[0, 2, 2:4, 1:3] = 0.7           # 4 points < 10: whole frame
    m[0, 3, 40:47, 55:63] = 0.5       # exactly at threshold; clamps at W-1/H-1
    m[0, 4, 0:5, 0:5] = 0.49          # below threshold everywhere: whole frame
    m[1, 1, 10:40, 5:60] = np.random.RandomState(7).rand(30, 55)
    m[1, 2, 0:2, 0:5] = 1.0           # exactly 10 points: a box
    m[1, 3, 46:48, 60:64] = 1.0       # 8 points: whole frame
    return m


@pytest.mark.parametrize("loose", [0, 8, 64])
def test_bboxes_exact(loose):
    m = _box_masks()
    j = jax_att._bboxes(jnp.asarray(m), 0.5, 10, loose)
    t = att_map._bboxes(_t(m), 0.5, 10, loose)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (t[:, 0] == 0).all()                              # slot-0 zero box
    assert t[0, 2].tolist() == [0, 63, 0, 47]                # too few points


@pytest.mark.parametrize("out_hw,offset", [((3, 4), (0, 0)), ((4, 5), (8, 8)),
                                           ((3, 5), (0, 3))])
def test_regional_attention_small_exact(out_hw, offset):
    m = _box_masks()
    aj, bj = jax_att.regional_attention_small(jnp.asarray(m), out_hw, offset, 16,
                                              0.5, 10, 8)
    at, bt = att_map.regional_attention_small(_t(m), out_hw, offset, 16, 0.5, 10, 8)
    assert at.dtype == torch.float32
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
