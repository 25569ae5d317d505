"""The port's training data pipeline against the JAX package's, on the CPU:
the native flow-affine op, every training transform, the seeded TRAIN
loader of every dataset in the registry, and the index builders.

Tolerances. Both packages run the same numpy code and draw from the same
seeded streams, so transforms and batches are held bit for bit. The native
op is built in both packages from the same source with the same g++ flags,
so RandomAffine is bit-identical too; where the JAX package's native
library is absent it falls back to numpy, and RandomAffine is then held to
1e-4, as tests/test_data_pipeline.py:168-182 holds native against numpy
(the bilinear taps are summed in another order).
"""

import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from rmnet_tpu.config import Config as JaxConfig
from rmnet_tpu.data import build_index as jax_build_index
from rmnet_tpu.data import datasets as jax_datasets
from rmnet_tpu.data import rng as jax_rng
from rmnet_tpu.data import transforms as jax_transforms
from rmnet_tpu.ops import flow_affine as jax_flow_affine

from rmnet_tpu_torch.config import Config
from rmnet_tpu_torch.data import build_index, datasets, flow_affine
from rmnet_tpu_torch.data import rng as port_rng
from rmnet_tpu_torch.data import transforms
from rmnet_tpu_torch.data.synthetic import make_synthetic_davis
from rmnet_tpu_torch.utils.seg_viz import get_segmentation

from tests.test_torch_data import point_at

HW = (48, 64)
CROP = 40


def _jax_native():
    from rmnet_tpu.native import flow_affine_native

    return flow_affine_native


def _random_affine(rs):
    a = np.eye(2, 3, dtype=np.float32)
    a[:, :2] += rs.uniform(-0.2, 0.2, (2, 2)).astype(np.float32)
    a[:, 2] = rs.uniform(-3, 3, 2).astype(np.float32)
    return a


# ----------------------------------------------------------- native op
@pytest.mark.parametrize("op", ["update_optical_flow", "affine_warp_bilinear",
                                "affine_warp_nearest"])
def test_native_op_matches_numpy_and_jax(op):
    """The port's native op against its numpy version (1e-4, the JAX
    package's tolerance for the same pair, tests/test_flow_affine.py:69);
    both bit-identical to the JAX package's counterparts."""
    rs = np.random.RandomState(2)
    if op == "update_optical_flow":
        flow = (rs.rand(41, 29, 2).astype(np.float32) - 0.5) * 25
        m1, m2 = _random_affine(rs), _random_affine(rs)
        native = flow_affine.update_optical_flow(flow, m1, m2)
        plain = flow_affine.update_optical_flow_numpy(flow, m1, m2)
        jax_plain = jax_flow_affine.update_optical_flow_numpy(flow, m1, m2)
        jax_native = _jax_native() and _jax_native().update_optical_flow(flow, m1, m2)
    else:
        nearest = op.endswith("nearest")
        img = rs.rand(16, 20, 3).astype(np.float32) * 255
        mat, fill = _random_affine(rs), (255.0, 0.0, 7.0)
        native = flow_affine.affine_warp(img, mat, fill, nearest)
        plain = flow_affine.affine_warp_numpy(img, mat, fill, nearest)
        jax_plain = jax_transforms.affine_warp_numpy(img, mat, fill, nearest)
        jax_native = _jax_native() and _jax_native().affine_warp(
            img, mat, np.asarray(fill, np.float32), nearest)
    assert native.dtype == np.float32 and native.shape == plain.shape
    np.testing.assert_allclose(native, plain, rtol=0, atol=1e-4 * max(1.0, np.abs(plain).max()))
    np.testing.assert_array_equal(plain, jax_plain)
    if jax_native is not None:
        np.testing.assert_array_equal(native, jax_native)


def test_native_op_keeps_the_reference_order():
    """y1 reads the x1 already transformed (flow_affine_transformation.cpp:
    72-73): a shear whose y row reads x gives the reference's value."""
    flow = np.zeros((4, 5, 2), np.float32)
    m1 = np.array([[1, 0, 2], [0.3, 1, 0.2]], np.float32)
    ident = np.eye(2, 3, dtype=np.float32)
    out = flow_affine.update_optical_flow(flow, m1, ident)
    jj, ii = np.meshgrid(np.arange(5, dtype=np.float32), np.arange(4, dtype=np.float32))
    x1 = np.round(jj + 2)
    y1 = np.round(np.float32(0.3) * x1 + ii + np.float32(0.2))  # the new x1, not jj
    np.testing.assert_array_equal(out[..., 0], np.clip(x1, 0, 4) - jj)
    np.testing.assert_array_equal(out[..., 1], np.clip(y1, 0, 3) - ii)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; nothing falls back to numpy."""
    bad = tmp_path / "flow_affine.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(flow_affine, "_SOURCE", bad)
    monkeypatch.setattr(flow_affine, "_BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(flow_affine, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        flow_affine.update_optical_flow(np.zeros((2, 2, 2), np.float32),
                                        np.eye(2, 3, dtype=np.float32),
                                        np.eye(2, 3, dtype=np.float32))


# ----------------------------------------------------------- transforms
def _clip(seed=0, T=3, H=HW[0], W=HW[1]):
    """uint8 frames, label maps with two objects and an ignore band, flows."""
    rs = np.random.RandomState(seed)
    frames = [rs.randint(0, 256, (H, W, 3)).astype(np.uint8) for _ in range(T)]
    masks = []
    for t in range(T):
        m = np.zeros((H, W), np.uint8)
        m[6 + 2 * t:26 + 2 * t, 8:30] = 1
        m[20:40, 34 + t:58 + t] = 3
        m[:, :2] = 255
        masks.append(m)
    flows = [((rs.rand(H, W, 2) - 0.5) * 6).astype(np.float32) for _ in range(T)]
    return frames, masks, flows


TRANSFORMS = {
    "RandomPermuteRGB": None,
    "RandomFlip": None,
    "Resize": {"size": 40, "keep_ratio": True},
    "Resize_square": {"size": 40, "keep_ratio": False},
    "RandomCrop": {"height": 32, "width": CROP, "ignore_idx": 255},
    "ColorJitter": {"brightness": (0.8, 1.2), "contrast": (0.7, 1.3),
                    "saturation": (0.6, 1.4), "hue": (-0.1, 0.1)},
    "HistogramEqualization": None,
    "RandomAffine": {"degrees": (-15, 15), "translate": (0.1, 0.1), "scale": (1.0, 1.3),
                     "shears": (-10, 10), "frame_fill_color": (255, 255, 255),
                     "mask_fill_color": 255, "optical_flow_fill_color": (0, 0)},
}


def _run(module, rng, name, seed):
    tr = module.Compose([{"callback": name.split("_")[0], "parameters": TRANSFORMS[name]}])
    frames, masks, flows = _clip(seed)
    rng.seed_stream(seed)
    try:
        return tr(frames, masks, flows)
    finally:
        rng.clear_stream()


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_training_transform_matches_jax(name):
    """Each training transform on the same clip and seeded stream, over
    four seeds (RandomFlip takes both branches)."""
    exact = name != "RandomAffine" or _jax_native() is not None
    for seed in range(4):
        got = _run(transforms, port_rng, name, seed)
        want = _run(jax_transforms, jax_rng, name, seed)
        for a_list, b_list in zip(got, want):
            assert len(a_list) == len(b_list) == 3
            for a, b in zip(a_list, b_list):
                a, b = np.asarray(a), np.asarray(b)
                assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype)
                if exact or a.dtype == np.uint8:
                    np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_transform_registry_matches_jax():
    assert set(transforms.Compose.REGISTRY) == set(jax_transforms.Compose.REGISTRY)


# -------------------------------------------------------------- loaders
IMAGE_SETS = ("PASCAL_VOC", "ECSSD", "MSRA10K", "MSCOCO", "ADE20K")


def _image_set(root, name, davis_tree, n=5):
    """``n`` images and palette masks (the DAVIS tree's first video) under
    root/name, with the set's id list -> (list path, image, mask templates)."""
    _, img_dir, ann_dir, _ = davis_tree
    base = os.path.join(root, name)
    os.makedirs(os.path.join(base, "images"))
    os.makedirs(os.path.join(base, "masks"))
    ids = ["%04d" % (i + 1) for i in range(n)] if name == "ECSSD" else [f"im{i}" for i in range(n)]
    for i, image_id in enumerate(ids):
        shutil.copy(os.path.join(img_dir, "vid00", f"{i:05d}.jpg"),
                    os.path.join(base, "images", f"{image_id}.jpg"))
        labels = np.array(Image.open(os.path.join(ann_dir, "vid00", f"{i:05d}.png")))
        labels[-3:] = 255  # an ignore band
        get_segmentation(None, labels).save(os.path.join(base, "masks", f"{image_id}.png"))
    index = os.path.join(base, "list.txt")
    with open(index, "w") as f:
        # the reference drops the last line of PASCAL VOC's list only
        f.write("\n".join(ids) + ("\n" if name == "PASCAL_VOC" else ""))
    return index, os.path.join(base, "images", "%s.jpg"), os.path.join(base, "masks", "%s.png")


def _youtube_vos(root, davis_tree):
    """A YouTube-VOS train split: video a1b2 (6 frames, stems 5 apart, its
    second object from the third frame on) and c3d4 (2 frames, drawn with
    replacement)."""
    _, img_dir, ann_dir, flo_dir = davis_tree
    meta = {"videos": {}}
    for name, src, n in (("a1b2", "vid00", 6), ("c3d4", "vid01", 2)):
        stems = [f"{5 * i:05d}" for i in range(n)]
        for sub, src_dir, ext in (("JPEGImages", img_dir, "jpg"), ("Annotations", ann_dir, "png"),
                                  ("OpticalFlows", flo_dir, "flo")):
            os.makedirs(os.path.join(root, "train", sub, name))
            for i, stem in enumerate(stems):
                shutil.copy(os.path.join(src_dir, src, f"{i:05d}.{ext}"),
                            os.path.join(root, "train", sub, name, f"{stem}.{ext}"))
        meta["videos"][name] = {"objects": {"1": {"frames": stems}, "2": {"frames": stems[2:]}}}
    with open(os.path.join(root, "train", "meta.json"), "w") as f:
        json.dump(meta, f)
    return os.path.join(root, "%s", "meta.json"), root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_trees"))
    davis = make_synthetic_davis(os.path.join(root, "davis"), n_videos=3, n_frames=[7, 5, 2],
                                 hw=HW)
    out = {"davis": davis, "ytvos": _youtube_vos(os.path.join(root, "ytvos"), davis)}
    for name in IMAGE_SETS:
        out[name] = _image_set(root, name, davis)
    return out


def _configure(cfg, trees):
    point_at(cfg, trees["davis"])
    yt_index, yt_root = trees["ytvos"]
    yt = cfg.DATASETS.YOUTUBE_VOS
    yt.INDEXING_FILE_PATH = yt_index
    yt.IMG_FILE_PATH = os.path.join(yt_root, "%s", "JPEGImages", "%s", "%s.jpg")
    yt.ANNOTATION_FILE_PATH = os.path.join(yt_root, "%s", "Annotations", "%s", "%s.png")
    yt.OPTICAL_FLOW_FILE_PATH = os.path.join(yt_root, "%s", "OpticalFlows", "%s", "%s.flo")
    for name in IMAGE_SETS:
        paths = getattr(cfg.DATASETS, name)
        paths.INDEXING_FILE_PATH, paths.IMG_FILE_PATH, paths.ANNOTATION_FILE_PATH = trees[name]
    cfg.DATASETS.ECSSD.N_IMAGES = 5
    aug = cfg.TRAIN.AUGMENTATION
    aug.RESIZE_SIZE, aug.CROP_HSIZE, aug.CROP_WSIZE = HW[0], CROP, CROP
    cfg.TRAIN.N_MAX_OBJECTS = 2
    return cfg


# DAVIS through the repeat syntax: a MultipleDatasets passes set_frame_step on
LOADER_DATASETS = {"DAVIS": ["DAVISx2"], "YOUTUBE_VOS": "YOUTUBE_VOS",
                   "DAVIS_FRAMES": "DAVIS_FRAMES", **{n: n for n in IMAGE_SETS}}


@pytest.mark.parametrize("n_workers", [0, 2], ids=["0_workers", "2_workers"])
@pytest.mark.parametrize("name", sorted(LOADER_DATASETS))
def test_train_loader_matches_jax(trees, name, n_workers):
    """Two epochs of the seeded, shuffled TRAIN loader at frame step 2,
    then 1: names, n_objects, frames, masks and flows bit for bit (see the
    module's docstring for RandomAffine without the JAX native library)."""
    exact = _jax_native() is not None
    runs = []
    for cfg, mod in ((_configure(Config(), trees), datasets),
                     (_configure(JaxConfig(), trees), jax_datasets)):
        ds = mod.DatasetCollector.get_dataset(cfg, LOADER_DATASETS[name], mod.DatasetSubset.TRAIN)
        loader = mod.DataLoader(ds, batch_size=2, shuffle=True, drop_last=True, seed=3,
                                n_workers=n_workers)
        batches = []
        for step in (2, 1):
            ds.set_frame_step(step)
            batches += list(loader)
        runs.append(batches)
    got, want = runs
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            assert a.dtype == b.dtype and a.shape == b.shape
            if exact or a.dtype != np.float32:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    names, n_objects, frames, masks, flows = got[0]
    assert frames.shape == (2, 3, CROP, CROP, 3) and frames.dtype == np.float32
    assert masks.shape == (2, 3, 3, CROP, CROP) and masks.dtype == np.uint8
    assert flows.shape == (2, 3, CROP, CROP, 2) and n_objects.shape == (2, 3)


def test_image_sets_refuse_other_subsets(trees):
    cfg = _configure(Config(), trees)
    with pytest.raises(ValueError, match="ONLY DatasetSubset.TRAIN"):
        datasets.DatasetCollector.get_dataset(cfg, "ECSSD", datasets.DatasetSubset.VAL)


def test_frame_indexes_match_jax(trees):
    """Frame-window sampling over lengths and steps, including windows that
    do not fit (a sorted sample) and short videos (with replacement)."""
    for n_frames in (2, 3, 5, 9, 40):
        for step in (1, 2, 7):
            got, want = [], []
            for mod, rng, out in ((datasets, port_rng, got), (jax_datasets, jax_rng, want)):
                ds = mod.VideoDataset([], None, {"ignore_idx": 255, "n_max_frames": 3,
                                                 "n_max_objects": 2})
                ds.set_frame_step(step)
                rng.seed_stream(n_frames * 31 + step)
                try:
                    out += [ds._get_frame_indexes(n_frames, 3) for _ in range(5)]
                finally:
                    rng.clear_stream()
            assert got == want


# ---------------------------------------------------------- build_index
@pytest.fixture(scope="module")
def index_root(trees, tmp_path_factory):
    """A DAVIS layout with ImageSets/2017 split files, beside the
    YouTube-VOS train split (and a valid split made from it)."""
    root = str(tmp_path_factory.mktemp("index"))
    davis = os.path.join(root, "DAVIS")
    shutil.copytree(os.path.dirname(trees["davis"][1]), os.path.join(davis, "JPEGImages"))
    os.makedirs(os.path.join(davis, "ImageSets", "2017"))
    for split, names in (("train.txt", "vid00\nvid02\n"), ("val.txt", "vid01\n")):
        with open(os.path.join(davis, "ImageSets", "2017", split), "w") as f:
            f.write(names)
    yt = os.path.join(root, "ytvos")
    shutil.copytree(os.path.join(trees["ytvos"][1], "train"), os.path.join(yt, "train"))
    shutil.copytree(os.path.join(trees["ytvos"][1], "train"), os.path.join(yt, "valid"))
    return root


@pytest.mark.parametrize("cmd", ["davis", "ytvos_train", "ytvos_valid", "imagelist"])
def test_build_index_matches_jax(index_root, trees, tmp_path, cmd):
    """Each builder's CLI writes the JAX package's file, byte for byte."""
    if cmd == "davis":
        args = ["davis", os.path.join(index_root, "DAVIS")]
    elif cmd.startswith("ytvos"):
        args = ["ytvos", os.path.join(index_root, "ytvos"), "--subset", cmd.split("_")[1]]
    else:
        args = ["imagelist", os.path.dirname(trees["MSRA10K"][1])]
    out = []
    for i, mod in enumerate((build_index, jax_build_index)):
        path = str(tmp_path / str(i) / "index")
        argv = args[:2] + [path] + args[2:]
        mod.main(argv)
        out.append(open(path).read())
    assert out[0] == out[1] and out[0]
    if cmd == "davis":
        index = json.loads(out[0])
        assert [v["n_frames"] for v in index["train"]] == [7, 2] and index["test"] == []
    if cmd == "ytvos_valid":
        objects = json.loads(out[0])["videos"]["a1b2"]["objects"]
        assert objects["1"]["frames"] == [f"{5 * i:05d}" for i in range(6)]
