"""The port's evaluation and export entry points against the JAX package's, at
f32 on the CPU: checkpoints, ``test_net``, ``inference_net`` and the runner.

One synthetic DAVIS tree (48x64, two videos of 6 and 4 frames, two objects)
and one reference-format .pth: the port's seeded random weights imported
into JAX variables, converted back with ``from_jax_variables`` and written
with the port's ``save_checkpoint``. Both packages' entry points load that
file. The JAX engine reads densely on the CPU; the port runs both its reads
(the block-sparse one through the plain version of the kernel).

Tolerances. At one scale the labels are equal except at pixels where the
two largest probabilities lie within TIE = 1e-5 of each other: the packages'
probabilities agree to about 7e-7 here, and on this tree one pixel (video 0,
frame 2) has its two objects 3e-7 apart, so its label follows the last bits
of the convolutions' arithmetic (it also flips between one stream and a
batch of two). Such a pixel moves J-Mean by 1.2e-6, so the scores are held
to 1e-5. With test-time augmentation (scales 1.0 and 0.75, the flip) the
probabilities agree only to the 5e-3 of tests/test_torch_engine_serving.py:
J&F within 1e-3.
"""

import copy
import glob
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rmnet_tpu.config import Config as JaxConfig
from rmnet_tpu.core import inference as jax_inference
from rmnet_tpu.core.engine import InferenceEngine as JaxEngine
from rmnet_tpu.models.rmnet import RMNet as JaxRMNet
from rmnet_tpu.models.tiny_flownet import TinyFlowNet as JaxTinyFlowNet
from rmnet_tpu.utils.checkpoint import load_weights_auto as jax_load_weights_auto

from rmnet_tpu_torch.config import Config
from rmnet_tpu_torch.data import DatasetCollector, DatasetSubset
from rmnet_tpu_torch.data.synthetic import make_synthetic_davis
from rmnet_tpu_torch.engine import InferenceEngine
from rmnet_tpu_torch.models.weights import build_models, from_jax_variables
from rmnet_tpu_torch.utils.checkpoint import latest_checkpoint, load_weights_auto, save_checkpoint
from rmnet_tpu_torch.utils.summary import SummaryWriter

from tests.test_torch_data import point_at
from tests.test_torch_engine import _jax_variables

torch.set_num_threads(2)

LENGTHS, HW = (6, 4), (48, 64)
TTA = dict(FRAME_SCALES=(1.0, 0.75), FLIP_LR=True)


def _zeros(variables):
    return jax.tree_util.tree_map(np.zeros_like, variables)


def _configure(cfg, files, out):
    point_at(cfg, files["tree"])
    cfg.CONST.N_WORKERS = 2
    cfg.CONST.WEIGHTS = files["pth"]
    cfg.TEST.MEMORIZE_EVERY = 2
    cfg.DIR.OUTPUT_DIR = out
    return cfg


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    tree = make_synthetic_davis(os.path.join(root, "davis"), n_videos=len(LENGTHS),
                                n_frames=LENGTHS, hw=HW)
    rmnet, tfn = build_models(seed=0, device="cpu")
    rm_vars = _jax_variables(JaxRMNet(), rmnet.state_dict(), jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 32, 32)), jnp.zeros((1, 32, 32)))
    tfn_vars = _jax_variables(JaxTinyFlowNet(), tfn.state_dict(), jnp.zeros((1, 2, 64, 64, 3)))
    pth = save_checkpoint(root, "ckpt-best", *from_jax_variables(rm_vars, tfn_vars),
                          epoch_index=7, best_metrics={"JF-Mean": 0.5})
    files = dict(root=root, tree=tree, pth=pth, rm_vars=rm_vars, tfn_vars=tfn_vars)
    cfg_file = os.path.join(root, "user_cfg.py")
    index_path, img_dir, ann_dir, flo_dir = tree
    with open(cfg_file, "w") as f:
        f.write("def configure(cfg):\n"
                f"    cfg.DATASETS.DAVIS.INDEXING_FILE_PATH = {index_path!r}\n"
                f"    cfg.DATASETS.DAVIS.IMG_FILE_PATH = {img_dir + '/%s/%05d.jpg'!r}\n"
                f"    cfg.DATASETS.DAVIS.ANNOTATION_FILE_PATH = {ann_dir + '/%s/%05d.png'!r}\n"
                f"    cfg.DATASETS.DAVIS.OPTICAL_FLOW_FILE_PATH = {flo_dir + '/%s/%05d.flo'!r}\n"
                f"    cfg.DIR.OUTPUT_DIR = {os.path.join(root, 'cli_out')!r}\n"
                "    cfg.CONST.N_WORKERS = 2\n"
                "    cfg.TEST.N_MAX_OBJECTS = 2\n"
                "    cfg.TEST.MEMORIZE_EVERY = 2\n")
    files["cfg_file"] = cfg_file
    return files


def configs(files, name, **test):
    """(JAX, port) configs over the tree and the .pth, TEST fields set."""
    out = os.path.join(files["root"], name)
    pair = (_configure(JaxConfig(), files, out + "_jax"), _configure(Config(), files, out))
    for cfg in pair:
        for k, v in test.items():
            setattr(cfg.TEST, k, v)
    return pair


def jax_engine(files, cfg):
    """The JAX engine with the weights of the .pth, read by the JAX package."""
    rm_vars, tfn_vars, _ = jax_load_weights_auto(
        files["pth"], _zeros(files["rm_vars"]), _zeros(files["tfn_vars"]))
    return JaxEngine(cfg, rm_vars, tfn_vars)


@pytest.fixture(scope="module")
def jax_scores(files):
    """The JAX test_net's Metrics.state_dict(): standalone (and its labels),
    in-training (video 1 only) and with test-time augmentation."""
    from rmnet_tpu.core.test import test_net as jax_test_net

    jcfg, _ = configs(files, "jax", TESTING_VIDEOS_INDEXES=(1,))
    eng, served = recording(jax_engine(files, jcfg))
    scores = {"single": jax_test_net(jcfg, engine=eng).state_dict(),
              "labels": [labels for _, labels in served],
              "in_training": jax_test_net(jcfg, epoch_idx=0, engine=eng).state_dict()}
    jcfg_tta, _ = configs(files, "jax_tta", **TTA)
    scores["tta"] = jax_test_net(jcfg_tta, engine=jax_engine(files, jcfg_tta)).state_dict()
    return scores


def _close(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


class _Wrapped:
    """An engine whose named methods are replaced; the rest is the engine's."""

    def __init__(self, engine, **methods):
        self._engine, self._methods = engine, methods

    def __getattr__(self, name):
        return self._methods.get(name) or getattr(self._engine, name)


def _fails(*args, **kwargs):
    raise RuntimeError("injected engine failure")


TIE = 1e-5  # probability margin under which a label may follow float noise


def recording(engine):
    """(engine wrapper, list): the wrapper appends (inputs, labels) of each
    video that run_video_labels or run_video_batch serves."""
    served = []

    def run_video_labels(frames, masks, n_objects):
        out = engine.run_video_labels(frames, masks, n_objects)
        served.append(((frames, masks, n_objects), out))
        return out

    def run_video_batch(videos):
        outs = engine.run_video_batch(videos)
        served.extend(zip([tuple(v) for v in videos], outs))
        return outs

    return _Wrapped(engine, run_video_labels=run_video_labels,
                    run_video_batch=run_video_batch), served


def assert_labels_agree(engine, videos, got, want):
    """``got`` and ``want`` label videos equal but where ``engine``'s
    probabilities for that video have their two largest within TIE."""
    assert len(got) == len(want) == len(videos)
    for (frames, masks, n_objects), a, b in zip(videos, got, want):
        assert a.shape == b.shape
        diff = a != b
        if diff.any():
            p = np.sort(engine.run_video(frames, masks, n_objects), axis=1)
            margins = (p[:, -1] - p[:, -2])[diff]
            assert margins.max() < TIE, (int(diff.sum()), float(margins.max()))


# ----------------------------------------------------------- checkpoints
def test_checkpoint_round_trip_through_jax(files):
    """The port's .pth gives the JAX package's load_weights_auto back the
    variables it was made from, exactly, and the port its state dicts."""
    rm_vars, tfn_vars, extras = jax_load_weights_auto(
        files["pth"], _zeros(files["rm_vars"]), _zeros(files["tfn_vars"]))
    for got, want in ((rm_vars, files["rm_vars"]), (tfn_vars, files["tfn_vars"])):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (path, a), (_, b) in zip(flat_got, flat_want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    assert extras == {"epoch": 7, "best_metrics": {"JF-Mean": 0.5}}
    rm_sd, tfn_sd, extras = load_weights_auto(files["pth"])
    want_rm, want_tfn = from_jax_variables(files["rm_vars"], files["tfn_vars"])
    for got, want in ((rm_sd, want_rm), (tfn_sd, want_tfn)):
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    # a weights-only .pth carries no optimizer state
    assert extras == {"epoch": 7, "best_metrics": {"JF-Mean": 0.5}, "optimizer": None}


def test_orbax_directory_is_refused(tmp_path):
    (tmp_path / "ckpt-best").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        load_weights_auto(str(tmp_path / "ckpt-best"))


def test_latest_checkpoint(files, tmp_path):
    assert latest_checkpoint(str(tmp_path / "none")) is None
    rm_sd, tfn_sd, _ = load_weights_auto(files["pth"])
    for epoch in (2, 10, 9):
        path = save_checkpoint(str(tmp_path), "ckpt-epoch-%03d" % epoch, rm_sd, tfn_sd,
                               epoch_index=epoch)
        assert path.endswith(".pth") and os.path.exists(path)
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt-epoch-010.pth")
    assert not glob.glob(str(tmp_path / "*.tmp"))


# --------------------------------------------------------------- test_net
@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_test_net_matches_jax(files, jax_scores, flash):
    from rmnet_tpu_torch.test import EvalStats, test_net as port_test_net

    _, cfg = configs(files, "port")
    engine = InferenceEngine(cfg, *load_weights_auto(files["pth"])[:2],
                             use_flash_attention=flash, device="cpu")
    wrapped, served = recording(engine)
    stats = EvalStats()
    got = port_test_net(cfg, engine=wrapped, stats=stats).state_dict()
    assert_labels_agree(engine, [v for v, _ in served], [labels for _, labels in served],
                        jax_scores["labels"])
    _close(got, jax_scores["single"], 1e-5)
    assert (stats.attempted, stats.scored, stats.skipped, stats.batch_fallbacks) == (2, 2, 0, 0)
    assert stats.frames == sum(LENGTHS) and stats.engine_s > 0 and stats.metrics_s > 0


def test_test_net_loads_the_weights_itself(files, jax_scores):
    """Without an engine, test_net builds one from CONST.WEIGHTS on the
    device it is given."""
    from rmnet_tpu_torch.test import test_net as port_test_net

    _, cfg = configs(files, "port")
    _close(port_test_net(cfg, device="cpu").state_dict(), jax_scores["single"], 1e-5)


def test_in_training_validation_matches_jax(files, jax_scores):
    """epoch_idx != -1 scores only TEST.TESTING_VIDEOS_INDEXES."""
    from rmnet_tpu_torch.test import EvalStats, test_net as port_test_net

    _, cfg = configs(files, "port", TESTING_VIDEOS_INDEXES=(1,))
    stats = EvalStats()
    got = port_test_net(cfg, epoch_idx=0, device="cpu", stats=stats).state_dict()
    _close(got, jax_scores["in_training"], 1e-5)
    assert (stats.attempted, stats.scored, stats.frames) == (1, 1, LENGTHS[1])


def test_n_streams_2_matches_one_stream(files):
    """TEST.N_STREAMS = 2 serves both videos (6 and 4 frames) as one ragged
    batch; labels and scores are those of one video at a time."""
    from rmnet_tpu_torch.test import EvalStats, test_net as port_test_net

    _, cfg = configs(files, "port")
    engine = InferenceEngine(cfg, *load_weights_auto(files["pth"])[:2], device="cpu")
    wrapped, served = recording(engine)
    one = port_test_net(cfg, engine=wrapped).state_dict()
    cfg2 = copy.deepcopy(cfg)
    cfg2.TEST.N_STREAMS = 2
    batches = []
    wrapped2, served2 = recording(_Wrapped(engine, run_video_batch=lambda videos: (
        batches.append([v[0].shape[0] for v in videos]) or engine.run_video_batch(videos))))
    stats = EvalStats()
    two = port_test_net(cfg2, engine=wrapped2, stats=stats).state_dict()
    assert batches == [list(LENGTHS)]
    assert (stats.scored, stats.skipped, stats.batch_fallbacks) == (2, 0, 0)
    assert_labels_agree(engine, [v for v, _ in served], [x for _, x in served2],
                        [x for _, x in served])
    _close(two, one, 1e-5)


def test_tta_matches_jax(files, jax_scores):
    """Scales 1.0 and 0.75 with the flip: J&F within 1e-3 of the JAX sweep."""
    from rmnet_tpu_torch.test import test_net as port_test_net

    _, cfg = configs(files, "port_tta", **TTA)
    got = port_test_net(cfg, device="cpu").state_dict()
    _close(got, jax_scores["tta"], 1e-3)


def test_failed_batch_is_served_again_and_counted(files):
    from rmnet_tpu_torch.test import EvalStats, test_net as port_test_net

    _, cfg = configs(files, "port", N_STREAMS=2)
    engine = InferenceEngine(cfg, *load_weights_auto(files["pth"])[:2], device="cpu")
    stats = EvalStats()
    got = port_test_net(cfg, engine=_Wrapped(engine, run_video_batch=_fails),
                        stats=stats).state_dict()
    assert (stats.scored, stats.skipped, stats.batch_fallbacks) == (2, 0, 1)
    cfg.TEST.N_STREAMS = 1
    _close(got, port_test_net(cfg, engine=engine).state_dict(), 0)


def test_failed_videos_are_counted_and_a_total_failure_raises(files):
    from rmnet_tpu_torch.test import EvalStats, test_net as port_test_net

    _, cfg = configs(files, "port")
    engine = _Wrapped(InferenceEngine(cfg, *load_weights_auto(files["pth"])[:2],
                                      device="cpu"), run_video_labels=_fails)
    with pytest.raises(RuntimeError, match="all 2 videos failed"):
        port_test_net(cfg, engine=engine)
    stats = EvalStats()
    got = port_test_net(cfg, engine=engine, raise_on_total_failure=False, stats=stats)
    assert (stats.attempted, stats.scored, stats.skipped) == (2, 0, 2)
    assert got.state_dict() == {"J-Mean": 0.0, "F-Mean": 0.0, "JF-Mean": 0.0}


def test_test_net_visualizes_through_a_writer(files):
    from rmnet_tpu_torch.test import test_net as port_test_net

    _, cfg = configs(files, "port", VISUALIZE_EVERY=3)
    engine = InferenceEngine(cfg, *load_weights_auto(files["pth"])[:2], device="cpu")
    log_dir = os.path.join(files["root"], "summaries")
    writer = SummaryWriter(log_dir, "test")
    port_test_net(cfg, epoch_idx=4, engine=engine, test_writer=writer)
    writer.close()
    images = sorted(os.listdir(os.path.join(log_dir, "test", "images")))
    assert images == ["DAVIS_vid00_Frame000-4.png", "DAVIS_vid00_Frame003-4.png"]
    assert np.array(Image.open(os.path.join(log_dir, "test", "images", images[0]))).shape \
        == (2 * HW[0], HW[1], 3)
    with open(os.path.join(log_dir, "test", "scalars.jsonl")) as f:
        assert len(f.read().splitlines()) == 3


# ---------------------------------------------------------- inference_net
def _pngs(out_dir):
    return sorted(glob.glob(os.path.join(out_dir, "benchmark", "default", "**", "*.png"),
                            recursive=True))


def test_inference_net_matches_jax(files, monkeypatch):
    """The palette PNGs of both packages: same files and palette, same
    indices but at near ties (assert_labels_agree).
    The JAX inference_net builds its variables only to have them overwritten
    by the .pth; the test hands it zeros of their shapes instead of paying
    the JAX init."""
    from rmnet_tpu_torch.inference import inference_net

    jcfg, cfg = configs(files, "png")
    monkeypatch.setattr(jax_inference, "build_models", lambda *a, **k: (
        None, None, _zeros(files["rm_vars"]), _zeros(files["tfn_vars"])))
    jax_inference.inference_net(jcfg)
    inference_net(cfg, device="cpu")
    got, want = _pngs(cfg.DIR.OUTPUT_DIR), _pngs(jcfg.DIR.OUTPUT_DIR)
    assert len(got) == sum(LENGTHS)
    assert [os.path.relpath(p, cfg.DIR.OUTPUT_DIR) for p in got] == \
        [os.path.relpath(p, jcfg.DIR.OUTPUT_DIR) for p in want]
    engine = InferenceEngine(cfg, *load_weights_auto(files["pth"])[:2], device="cpu")
    ds = DatasetCollector.get_dataset(cfg, "DAVIS", DatasetSubset.TEST)
    videos, labels, jax_labels = [], [], []
    for i, n in enumerate(LENGTHS):
        _, n_objects, frames, masks, _ = ds[i]
        videos.append((frames, masks, n_objects))
        pngs = [Image.open(p) for p in got[sum(LENGTHS[:i]):sum(LENGTHS[:i + 1])]]
        jax_pngs = [Image.open(p) for p in want[sum(LENGTHS[:i]):sum(LENGTHS[:i + 1])]]
        for a, b in zip(pngs, jax_pngs):
            assert a.mode == b.mode == "P" and a.getpalette() == b.getpalette()
        labels.append(np.stack([np.array(a) for a in pngs]))
        jax_labels.append(np.stack([np.array(b) for b in jax_pngs]))
    assert_labels_agree(engine, videos, labels, jax_labels)


def test_inference_net_overlays(files):
    from rmnet_tpu_torch.inference import inference_net

    _, cfg = configs(files, "overlays")
    inference_net(cfg, save_overlays=True, device="cpu")
    pngs = _pngs(cfg.DIR.OUTPUT_DIR)
    assert len(pngs) == sum(LENGTHS)
    assert np.array(Image.open(pngs[0])).shape == HW + (3,)


# ----------------------------------------------------------------- runner
def test_runner_test_and_inference(files, caplog):
    from rmnet_tpu_torch.runner import main

    base = ["--device", "cpu", "--cfg", files["cfg_file"], "--weights", files["pth"]]
    with caplog.at_level(logging.INFO):
        main(base + ["--test"])
    summary = [r.getMessage() for r in caplog.records if "[Test Summary]" in r.getMessage()]
    assert len(summary) == 1
    main(base + ["--inference", "--exp", "cli", "--set", "CONST.N_WORKERS=0"])
    pngs = glob.glob(os.path.join(files["root"], "cli_out", "benchmark", "cli", "**", "*.png"),
                     recursive=True)
    assert len(pngs) == sum(LENGTHS)


def test_runner_refusals(files):
    from rmnet_tpu_torch.runner import main

    base = ["--device", "cpu", "--cfg", files["cfg_file"]]
    with pytest.raises(SystemExit) as ex:
        main(base + ["--test"])
    assert ex.value.code == 2
    with pytest.raises(AttributeError, match="unknown config field"):
        main(base + ["--test", "--weights", files["pth"], "--set", "TRAIN.NO_SUCH=1"])
    # training is ported: an unknown network exits 1 (the JAX runner's code)
    with pytest.raises(SystemExit) as ex:
        main(base + ["--set", "TRAIN.NETWORK=Bogus"])
    assert ex.value.code == 1
    # the eval server is ported: one poll of a directory without checkpoints
    # scores nothing and returns
    empty = os.path.join(files["root"], "no_checkpoints")
    os.makedirs(empty, exist_ok=True)
    main(base + ["--eval-server", "--ckpt-dir", empty, "--max-iterations", "1",
                 "--poll-seconds", "0"])


def test_entry_points_default_to_the_card(files, monkeypatch):
    """device=None means CUDA; with no card they raise rather than run on the
    CPU."""
    from rmnet_tpu_torch.inference import inference_net
    from rmnet_tpu_torch.runner import main
    from rmnet_tpu_torch.test import test_net as port_test_net
    from rmnet_tpu_torch.train import train_net

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = configs(files, "card")
    for call in (lambda: port_test_net(cfg), lambda: inference_net(cfg), lambda: train_net(cfg),
                 lambda: main(["--cfg", files["cfg_file"], "--test", "--weights", files["pth"]]),
                 lambda: main(["--cfg", files["cfg_file"]]),
                 lambda: main(["--cfg", files["cfg_file"], "--eval-server", "--ckpt-dir",
                               files["root"], "--max-iterations", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_eval_read_is_a_kernel_case_of_the_card_tests():
    """The eval path's read (10 object rows of K = TEST.N_MAX_OBJECTS + 1
    slots, S = the auto capacity 32 plus the ephemeral slot, 480x854 on the
    /16 grid, f32) is a forward case of chip_smoke.py, and so of
    tests/test_torch_kernels_gpu.py; the backward never takes it."""
    import chip_smoke

    case = chip_smoke.KERNEL_CASES["eval_N10_S33_f32"]
    assert case[:5] == (Config().TEST.N_MAX_OBJECTS, 33, 30, 54, torch.float32)
    assert "eval_N10_S33_f32" in chip_smoke.FWD_ONLY_CASES
    assert "eval_N10_S33_f32" not in chip_smoke.BWD_CASES
    eng = InferenceEngine.__new__(InferenceEngine)
    eng.capacity, eng.use_flash_attention = 0, True
    eng.memorize_every = Config().TEST.MEMORIZE_EVERY
    T = max(chip_smoke.EVAL_LENGTHS)
    _, commit = eng._video_flags(np.full((T,), 2), T)
    assert eng._capacity_for(T, commit) + 1 == case[1]
