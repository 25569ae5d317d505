"""Rank functions of tests/test_torch_spatial.py. They run in processes that
``rmnet_tpu_torch.parallel.launch`` starts with the ``spawn`` method, which
import this module by name: it imports torch and the port, never JAX or
rmnet_tpu, and each rank reports whether either got imported."""

import dataclasses
import sys

import numpy as np
import torch

from rmnet_tpu_torch.models.rmnet import RMNet, RMNetApply
from rmnet_tpu_torch.ops.att_map import _bboxes, regional_attention_small
from rmnet_tpu_torch.ops.warp import backward_warp
from rmnet_tpu_torch.parallel import space
from rmnet_tpu_torch.parallel.space import WidthMesh, spatial_forward_video

# the halo ops' geometry: a 24 x 60 frame, padded to 32 x 64 (two columns of
# padding at each side), 4 columns of the /16 grid
OPS_HW = (24, 60)
CONV_CASES = ((7, 2, 3), (3, 1, 1), (3, 2, 1), (1, 2, 0))  # kernel, stride, padding
LOOSE = 8  # tests/test_rmnet_forward.py's n_bbox_loose_pixels


def op_inputs(seed=0):
    """The halo ops' whole inputs, float32 from numpy: a conv input at each
    resolution the cases take (name -> (N, C, H, W)), weights and a bias,
    masks for the boxes (3 objects: one in the first two ranks' columns
    only, one with too few points, one across the frame) and a flow whose
    vectors point up to 40 columns away, across two shards at 4 ranks."""
    rs = np.random.RandomState(seed)
    H, W = OPS_HW
    f32 = lambda *shape: rs.standard_normal(shape).astype(np.float32)  # noqa: E731
    masks = np.zeros((2, 4, H, W), np.float32)
    masks[:, 1, 3:15, 4:26] = rs.rand(2, 12, 22)
    masks[:, 2, 10, 30:35] = 1.0
    masks[:, 3, 5:20, 8:57] = rs.rand(2, 15, 49)
    flow = np.stack([rs.uniform(-40, 40, (2, H, W)), rs.uniform(-6, 6, (2, H, W))], -1)
    return dict(
        full=f32(2, 3, 32, 64), half=f32(2, 4, 32, 32), quarter=f32(2, 4, 8, 16),
        grid=f32(2, 4, 2, 4),
        weights={k: f32(5, 3 if k[0] == 7 else 4, k[0], k[0]) for k in CONV_CASES},
        bias=f32(5), masks=masks, flow=flow.astype(np.float32), image=f32(2, H, W, 3))


def op_cases(x):
    """Per case: a function of (input, width mesh or None) and its input."""
    t = {k: torch.from_numpy(v) for k, v in x.items() if isinstance(v, np.ndarray)}
    cases = {}
    for k, s, p in CONV_CASES:
        w = torch.from_numpy(x["weights"][(k, s, p)])
        src = "full" if k == 7 else "half"

        def conv(z, sp, w=w, s=s, p=p):
            if sp is None:
                return torch.nn.functional.conv2d(z, w, t["bias"], s, p)
            return sp.conv2d(z, w, t["bias"], s, p)

        cases[f"conv{k}_s{s}_p{p}"] = (conv, src)
    cases["max_pool"] = (lambda z, sp: torch.nn.functional.max_pool2d(z, 3, 2, 1)
                         if sp is None else sp.max_pool(z, 3, 2, 1), "half")
    for f, src in ((2, "grid"), (4, "quarter")):
        cases[f"upsample{f}"] = (
            lambda z, sp, f=f: torch.nn.functional.interpolate(
                z, size=(z.shape[-2] * f, z.shape[-1] * f), mode="bilinear",
                align_corners=False) if sp is None else sp.upsample(z, f), src)
    return t, cases


def _jax_imported() -> bool:
    return any(m.split(".")[0] in ("jax", "jaxlib", "flax", "rmnet_tpu") for m in sys.modules)


def halo_ops(mesh, x):
    """Every halo op of ``op_cases`` on the rank's columns of its input, the
    regional boxes (padded and frame coordinates) and the warp of the rank's
    columns -> {name: the rank's output}."""
    width = WidthMesh.build(mesh, *OPS_HW)
    t, cases = op_cases(x)
    out = {}
    for name, (fn, src) in cases.items():
        z = t[src]
        lo, hi = width.grid[width.rank]
        per = z.shape[-1] // width.grid[-1][1]
        out[name] = fn(z[..., lo * per:hi * per], width).numpy()
    masks = t["masks"]
    lw, uw, lh, uh = width.pads
    padded = torch.nn.functional.pad(masks, (lw, uw, lh, uh))
    h, w16 = padded.shape[-2] // 16, width.grid[width.rank][1] - width.grid[width.rank][0]
    for name, mask, shard, offset in (
            ("boxes_padded", width.padded_slice(padded), width.box_shard(True), (0, 0)),
            ("boxes_frame", width.unpadded_slice(masks), width.box_shard(False), (lh, lw))):
        att, boxes = regional_attention_small(mask, (h, w16), offset, 16, 0.5, 10, LOOSE,
                                              shard)
        out[name] = boxes.numpy()
        out[name.replace("boxes", "raster")] = att.numpy()
    no_hit = width.unpadded_slice(masks)[:, :2] * 0  # no rank has a hit
    out["boxes_no_hit"] = _bboxes(no_hit, 0.5, 10, LOOSE, width.box_shard(False)).numpy()
    u0 = width.unpadded_columns()[0]
    warped, valid = backward_warp(t["image"], width.unpadded_slice(t["flow"].movedim(-1, 1))
                                  .movedim(1, -1), u0)
    out["warp"], out["warp_valid"] = warped.numpy(), valid.numpy()
    return out


def _model(state_path):
    model = RMNet()
    model.load_state_dict(torch.load(state_path, weights_only=True))
    return model.eval()


def spatial_forward(mesh, state_path, clip, x):
    """One launch's work: the halo ops (``halo_ops``); the port's
    spatial_forward_video on ``clip`` twice (memorize_every=1, the
    tests' loose box) with the plans cached before and after each call, the
    collectives of the first call by kind, and the width of each encoder
    stage's output (r2, r3, r4 of both trunks, from forward hooks); then once
    with trainable BatchNorm in float64 (the estimate and the
    statistics)."""
    torch.set_num_threads(1)
    out = dict(ops=halo_ops(mesh, x))
    model = _model(state_path)
    apply = RMNetApply(model, memorize_every=1, n_bbox_loose_pixels=LOOSE)
    widths = {}
    hooks = [getattr(model, enc).get_submodule(stage).register_forward_hook(
        lambda m, i, o, key=f"{enc}.{stage}": widths.setdefault(key, set()).add(o.shape[-1]))
        for enc in ("encoder_memory", "encoder_query") for stage in ("res2", "res3", "res4")]
    plans = [len(space._SPATIAL_PLANS)]
    mesh.counts.clear()
    est = spatial_forward_video(apply, *clip, mesh).numpy()
    counts = {k: list(v) for k, v in mesh.counts.items()}
    plans.append(len(space._SPATIAL_PLANS))
    for h in hooks:
        h.remove()
    again = spatial_forward_video(apply, *clip, mesh).numpy()
    plans.append(len(space._SPATIAL_PLANS))
    hooked = [m for m in model.modules() if getattr(m, "space", None) is not None]
    # trainable BatchNorm in float64, where E[x^2] - mean^2 loses nothing
    # that matters (in float32 the clip's boxes flip with the order of sums)
    apply64 = dataclasses.replace(apply, model=_model(state_path).double(), train_bn=True)
    bn_est, bn = spatial_forward_video(apply64, *(np.asarray(c, np.float64) for c in clip[:3]),
                                       clip[3], mesh)
    out.update(est=est, again=again, plans=plans, counts=counts,
               widths={k: sorted(v) for k, v in widths.items()}, hooks_left=len(hooked),
               bn_est=bn_est.numpy(), bn={k: v.numpy() for k, v in bn.items()},
               jax_imported=_jax_imported())
    return out
