"""The port's host-side pipeline against the JAX package's, on the CPU: the
synthetic tree, the loader, .flo IO, the J&F metrics, the meters, the
palette PNGs, the config tree, the summary writer and the trace hook.

Everything here is numpy and Pillow on both sides, so the comparisons are
exact: bit for bit for data, 1e-12 for the metrics.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError

from rmnet_tpu.config import Config as JaxConfig
from rmnet_tpu.data import datasets as jax_datasets
from rmnet_tpu.data.io import read_flo as jax_read_flo
from rmnet_tpu.data.synthetic import make_synthetic_davis as jax_make_synthetic_davis
from rmnet_tpu.utils import metrics as jax_metrics
from rmnet_tpu.utils.average_meter import AverageMeter as JaxAverageMeter
from rmnet_tpu.utils.seg_viz import get_segmentation as jax_get_segmentation

from rmnet_tpu_torch import config as port_config
from rmnet_tpu_torch.config import Config
from rmnet_tpu_torch.data import datasets
from rmnet_tpu_torch.data.io import IO, read_flo, write_flo
from rmnet_tpu_torch.data.synthetic import make_synthetic_davis
from rmnet_tpu_torch.utils import metrics
from rmnet_tpu_torch.utils.average_meter import AverageMeter
from rmnet_tpu_torch.utils.profiling import trace_if
from rmnet_tpu_torch.utils.seg_viz import PALETTE, get_segmentation
from rmnet_tpu_torch.utils.summary import SummaryWriter

N_VIDEOS, N_FRAMES, HW = 2, 5, (48, 64)


def point_at(cfg, tree):
    index_path, img_dir, ann_dir, flo_dir = tree
    cfg.DATASETS.DAVIS.INDEXING_FILE_PATH = index_path
    cfg.DATASETS.DAVIS.IMG_FILE_PATH = img_dir + "/%s/%05d.jpg"
    cfg.DATASETS.DAVIS.ANNOTATION_FILE_PATH = ann_dir + "/%s/%05d.png"
    cfg.DATASETS.DAVIS.OPTICAL_FLOW_FILE_PATH = flo_dir + "/%s/%05d.flo"
    cfg.TEST.N_MAX_OBJECTS = 2
    return cfg


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The JAX package's synthetic tree and the port's, same arguments."""
    jax_tree = jax_make_synthetic_davis(str(tmp_path_factory.mktemp("jax_davis")),
                                        n_videos=N_VIDEOS, n_frames=N_FRAMES, hw=HW)
    port_tree = make_synthetic_davis(str(tmp_path_factory.mktemp("port_davis")),
                                     n_videos=N_VIDEOS, n_frames=N_FRAMES, hw=HW)
    return jax_tree, port_tree


# ----------------------------------------------------------------- tree
def _files(tree, sub):
    root = os.path.dirname(tree[0])
    base = os.path.join(root, sub)
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, fs in os.walk(base) for f in fs)


def test_synthetic_tree_matches_jax(trees):
    """Same index, masks (indices and palette) and flows byte for byte; the
    frames, JPEG from Pillow on both sides, decode to equal arrays."""
    jax_tree, port_tree = trees
    with open(jax_tree[0]) as a, open(port_tree[0]) as b:
        assert json.load(a) == json.load(b)
    for sub in ("JPEGImages/480p", "Annotations/480p", "OpticalFlows/480p"):
        assert _files(jax_tree, sub) == _files(port_tree, sub)
    for rel in _files(jax_tree, "Annotations/480p"):
        a, b = (Image.open(os.path.join(t[2], rel)) for t in trees)
        assert a.mode == b.mode == "P"
        np.testing.assert_array_equal(np.array(a), np.array(b))
        assert a.getpalette() == b.getpalette()
    for rel in _files(jax_tree, "OpticalFlows/480p"):
        with open(os.path.join(jax_tree[3], rel), "rb") as a, \
                open(os.path.join(port_tree[3], rel), "rb") as b:
            assert a.read() == b.read()
    for rel in _files(jax_tree, "JPEGImages/480p"):
        a, b = (np.array(Image.open(os.path.join(t[1], rel))) for t in trees)
        np.testing.assert_array_equal(a, b)


def test_synthetic_tree_per_video_lengths(tmp_path):
    index_path, *_ = make_synthetic_davis(str(tmp_path), n_videos=2, n_frames=[3, 6], hw=HW)
    with open(index_path) as f:
        index = json.load(f)
    assert [v["n_frames"] for v in index["val"]] == [3, 6]
    with pytest.raises(ValueError):
        make_synthetic_davis(str(tmp_path / "bad"), n_videos=3, n_frames=[3, 6])


# --------------------------------------------------------------- loader
def _batches(loader):
    return [(names, n_objects, frames, masks, flows)
            for names, n_objects, frames, masks, flows in loader]


@pytest.mark.parametrize("subset", ["VAL", "TEST"])
@pytest.mark.parametrize("n_workers,shuffle", [(0, False), (2, False), (2, True)],
                         ids=["0_workers", "2_workers", "2_workers_shuffled"])
def test_loader_matches_jax(trees, subset, n_workers, shuffle):
    """The port's DataLoader over the JAX package's tree: names, n_objects,
    frames, masks and flows bit for bit, in the JAX loader's order."""
    jax_cfg, cfg = point_at(JaxConfig(), trees[0]), point_at(Config(), trees[0])
    got = _batches(datasets.DataLoader(
        datasets.DatasetCollector.get_dataset(cfg, "DAVIS", datasets.DatasetSubset[subset]),
        shuffle=shuffle, seed=3, n_workers=n_workers))
    want = _batches(jax_datasets.DataLoader(
        jax_datasets.DatasetCollector.get_dataset(
            jax_cfg, "DAVIS", jax_datasets.DatasetSubset[subset]),
        shuffle=shuffle, seed=3, n_workers=n_workers))
    assert len(got) == len(want) == N_VIDEOS
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    names, n_objects, frames, masks, flows = got[0]
    assert frames.shape == (1, N_FRAMES) + HW + (3,) and frames.dtype == np.float32
    assert masks.shape == (1, N_FRAMES, 3) + HW and masks.dtype == np.uint8
    assert flows.shape == (1, N_FRAMES) + HW + (2,)
    assert n_objects.tolist() == [[2] * N_FRAMES]


@pytest.mark.parametrize("subset", ["VAL", "TEST"])
def test_youtube_vos_file_lists_match_jax(tmp_path, subset):
    """The YouTube-VOS index (one meta.json per subset: each video's frames
    are the union of its objects' frames) gives the JAX package's lists."""
    sub = {"VAL": "valid", "TEST": "test"}[subset]
    (tmp_path / sub).mkdir()
    meta = {"videos": {"a1b2": {"objects": {"1": {"frames": ["00005", "00000"]},
                                            "2": {"frames": ["00010", "00005"]}}},
                       "c3d4": {"objects": {"1": {"frames": ["00000"]}}}}}
    (tmp_path / sub / "meta.json").write_text(json.dumps(meta))
    lists = []
    for cfg, mod in ((Config(), datasets), (JaxConfig(), jax_datasets)):
        cfg.DATASETS.YOUTUBE_VOS.INDEXING_FILE_PATH = str(tmp_path / "%s" / "meta.json")
        ds = mod.DatasetCollector.get_dataset(cfg, "YOUTUBE_VOS", mod.DatasetSubset[subset])
        lists.append(ds.file_list)
    assert lists[0] == lists[1]
    assert [v["n_frames"] for v in lists[0]] == [3, 1]
    assert lists[0][0]["frames"][-1].endswith(f"{sub}/JPEGImages/a1b2/00010.jpg")


def test_repeat_syntax_concatenates(trees):
    cfg = point_at(Config(), trees[0])
    ds = datasets.DatasetCollector.get_dataset(cfg, ["DAVISx2"], datasets.DatasetSubset.VAL)
    assert len(ds) == 2 * N_VIDEOS
    assert ds[N_VIDEOS][0] == ds[0][0] == "DAVIS/vid00"


def test_loader_raises_a_worker_error(trees, tmp_path):
    """A file that fails to decode in a worker thread raises on the
    consumer's thread."""
    cfg = point_at(Config(), trees[0])
    ds = datasets.DatasetCollector.get_dataset(cfg, "DAVIS", datasets.DatasetSubset.VAL)
    bad = tmp_path / "broken.jpg"
    bad.write_bytes(b"not a jpeg")
    ds.file_list[1]["frames"][0] = str(bad)
    loader = datasets.DataLoader(ds, n_workers=2)
    with pytest.raises(UnidentifiedImageError):
        _batches(loader)


# ------------------------------------------------------------------- io
def test_flo_round_trip(tmp_path):
    flow = np.random.RandomState(0).randn(7, 9, 2).astype(np.float32)
    path = str(tmp_path / "x.flo")
    write_flo(path, flow)
    data = open(path, "rb").read()
    np.testing.assert_array_equal(read_flo(data), flow)
    np.testing.assert_array_equal(jax_read_flo(data), flow)
    np.testing.assert_array_equal(IO.get(path), flow)
    with pytest.raises(ValueError, match="Invalid .flo"):
        read_flo(b"XXXX" + data[4:])


def test_io_get_and_cache(tmp_path):
    assert IO.get(str(tmp_path / "missing.png")) is None
    with pytest.raises(ValueError, match="Unsupported file extension"):
        (tmp_path / "a.txt").write_text("x")
        IO.get(str(tmp_path / "a.txt"))
    path = str(tmp_path / "m.png")
    get_segmentation(None, np.eye(4, dtype=np.uint8)).save(path)
    try:
        IO.enable_cache(capacity_bytes=1 << 20)
        first = np.array(IO.get(path))
        assert IO.cache.get(path) == open(path, "rb").read()
        np.testing.assert_array_equal(np.array(IO.get(path)), first)
        np.testing.assert_array_equal(first, np.eye(4))
    finally:
        IO.cache = None


# -------------------------------------------------------------- metrics
def _label_videos(seed, T=5, H=40, W=56, K=3):
    """Random blocky label videos: object 3 of the prediction is absent from
    the ground truth, the ground truth's object 2 is empty on frame 2."""
    rs = np.random.RandomState(seed)
    gt = rs.randint(0, K + 1, (T, H // 8, W // 8)).repeat(8, 1).repeat(8, 2).astype(np.uint8)
    pred = gt.copy()
    noise = rs.rand(T, H, W) < 0.2
    pred[noise] = rs.randint(0, K + 2, int(noise.sum()))
    gt[2][gt[2] == 2] = 0
    return pred, gt


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_workers", [None, 3], ids=["serial", "threaded"])
def test_metrics_get_matches_jax(seed, n_workers):
    pred, gt = _label_videos(seed)
    got = metrics.Metrics.get(pred, gt, n_workers=n_workers)
    want = jax_metrics.Metrics.get(pred, gt, n_workers=n_workers)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got == metrics.Metrics.get(pred, gt)  # threads change nothing


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_f_score_and_bmap_match_jax(seed):
    pred, gt = _label_videos(seed)
    for t in range(pred.shape[0]):
        for k in range(5):
            p, g = pred[t] == k, gt[t] == k
            assert abs(metrics.get_iou(p, g) - jax_metrics.get_iou(p, g)) <= 1e-12
            assert abs(metrics.get_f_score(p, g) - jax_metrics.get_f_score(p, g)) <= 1e-12
            np.testing.assert_array_equal(metrics.seg2bmap(p), jax_metrics.seg2bmap(p))


def test_empty_masks_score_one():
    empty = np.zeros((8, 8), bool)
    assert metrics.get_iou(empty, empty) == 1.0
    assert metrics.get_f_score(empty, empty) == 1.0


def test_metrics_value_object():
    a = metrics.Metrics("JF-Mean", [0.5, 0.6, 0.55])
    b = metrics.Metrics("JF-Mean", {"JF-Mean": 0.7, "Other": 1.0})
    assert a.state_dict() == {"J-Mean": 0.5, "F-Mean": 0.6, "JF-Mean": 0.55}
    assert b.better_than(a) and not a.better_than(b) and a.better_than(None)
    assert metrics.Metrics.names() == jax_metrics.Metrics.names()
    with pytest.raises(TypeError):
        metrics.Metrics("JF-Mean", 0.5)


def test_average_meter_matches_jax():
    ours, theirs = AverageMeter(["a", "b"]), JaxAverageMeter(["a", "b"])
    scalar, jax_scalar = AverageMeter(), JaxAverageMeter()
    for values, weight in (([1.0, 2.0], 2), ([3.0, 5.0], 1), ([0.5, 0.25], 3)):
        ours.update(values, weight)
        theirs.update(values, weight)
        scalar.update(values[0], weight)
        jax_scalar.update(values[0], weight)
    assert ours.avg() == theirs.avg() and ours.val() == theirs.val()
    assert ours.count() == theirs.count() and ours.avg(1) == theirs.avg(1)
    assert scalar.avg() == jax_scalar.avg() and scalar.count() == jax_scalar.count()


# -------------------------------------------------------------- seg_viz
def test_segmentation_images_match_jax():
    rs = np.random.RandomState(0)
    mask = rs.randint(0, 12, (24, 32)).astype(np.uint8)
    mask[0, 0] = 255
    frame = rs.randn(24, 32, 3).astype(np.float32)
    norm = {"mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225)}
    png, jax_png = get_segmentation(None, mask), jax_get_segmentation(None, mask)
    assert png.mode == "P" and png.getpalette() == jax_png.getpalette()
    assert png.getpalette() == PALETTE.reshape(-1).tolist()
    np.testing.assert_array_equal(np.array(png), np.array(jax_png))
    np.testing.assert_array_equal(np.array(get_segmentation(frame, mask, norm)),
                                  np.array(jax_get_segmentation(frame, mask, norm)))


# --------------------------------------------------------------- config
def _tree(node, prefix=""):
    """{dotted field: default} of a config tree, walked recursively."""
    out = {}
    for f in dataclasses.fields(node):
        value = getattr(node, f.name)
        if dataclasses.is_dataclass(value):
            out.update(_tree(value, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = value
    return out


def test_config_tree_matches_jax():
    """Every field of the JAX tree, with its default, but the ones that the
    port's docstring lists as differing by design."""
    ours, theirs = _tree(Config()), _tree(JaxConfig())
    assert ours.keys() == theirs.keys()
    differ = sorted(k for k in ours if ours[k] != theirs[k])
    assert differ == sorted(port_config.DEFAULTS_THAT_DIFFER)
    for name in port_config.DEFAULTS_THAT_DIFFER:
        assert name in port_config.__doc__
    assert Config().TRAIN.FLASH_ATTENTION is True


@pytest.mark.parametrize("form", ["configure", "CFG"])
def test_config_file_and_overrides_load_alike(tmp_path, form):
    path = tmp_path / "user_cfg.py"
    if form == "configure":
        path.write_text("def configure(cfg):\n"
                        "    cfg.TEST.N_MAX_OBJECTS = 4\n"
                        "    cfg.TRAIN.AUGMENTATION.CROP_HSIZE = 240\n"
                        "    cfg.CONST.EXP_NAME = 'fromfile'\n")
    else:
        path.write_text("CFG = {'TEST': {'N_MAX_OBJECTS': 4}, 'CONST': {'EXP_NAME': "
                        "'fromfile'}, 'TRAIN': {'AUGMENTATION': {'CROP_HSIZE': 240}}}\n")
    overrides = ["TEST.MEMORIZE_EVERY=3", "TEST.FRAME_SCALES=(1.0, 0.75)",
                 "TRAIN.NETWORK=TinyFlowNet", "DIR.OUTPUT_DIR=/tmp/x"]
    ours = Config.from_file(str(path)).apply_overrides(overrides)
    theirs = JaxConfig.from_file(str(path)).apply_overrides(overrides)
    a, b = _tree(ours), _tree(theirs)
    for name in port_config.DEFAULTS_THAT_DIFFER:
        del a[name], b[name]
    assert a == b
    assert ours.TEST.N_MAX_OBJECTS == 4 and ours.TEST.FRAME_SCALES == (1.0, 0.75)
    assert ours.TRAIN.AUGMENTATION.CROP_HSIZE == 240 and ours.TRAIN.NETWORK == "TinyFlowNet"


def test_config_rejects_unknown_fields(tmp_path):
    with pytest.raises(AttributeError, match="unknown config field"):
        Config().apply_overrides(["TRAIN.NO_SUCH=1"])
    path = tmp_path / "empty_cfg.py"
    path.write_text("X = 1\n")
    with pytest.raises(ValueError, match="configure"):
        Config.from_file(str(path))
    assert Config.from_file(None) == Config()


# ----------------------------------------------------- summary, profiling
def test_summary_writer(tmp_path):
    writer = SummaryWriter(str(tmp_path), "test")
    writer.add_scalar("Metric/JF-Mean", np.float32(0.25), 3)
    writer.add_image("DAVIS/vid00/Frame000", np.zeros((4, 6, 3), np.uint8), 3)
    writer.close()
    lines = (tmp_path / "test" / "scalars.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in lines] == [
        {"tag": "Metric/JF-Mean", "value": 0.25, "step": 3}]
    img = np.array(Image.open(tmp_path / "test" / "images" / "DAVIS_vid00_Frame000-3.png"))
    assert img.shape == (4, 6, 3)


def test_trace_if_writes_a_chrome_trace(tmp_path, monkeypatch):
    import torch

    monkeypatch.delenv("RMNET_TRACE_DIR", raising=False)
    with trace_if():  # no directory: nothing traced
        pass
    with trace_if(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
    monkeypatch.setenv("RMNET_TRACE_DIR", str(tmp_path / "trace"))
    with trace_if():
        torch.ones(8).add_(1)
    trace = json.loads((tmp_path / "trace" / "rmnet_trace.json").read_text())
    assert trace["traceEvents"]
