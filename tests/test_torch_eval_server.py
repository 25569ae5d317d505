"""The port's eval server and device farm on the CPU (the counterpart of
tests/test_eval_server_farm.py, over lists of CPU devices).

A synthetic DAVIS tree (48x64, videos of 6 and 4 frames, two objects) and
three reference-format checkpoints of the port's seeded random weights
(seeds 0, 1, 2). The engines read through the plain version of the flash
kernel, as the port's CPU runs do. Each checkpoint's scores must equal the
port's ``test_net`` on the same checkpoint exactly: the server runs that
same sweep on an engine that took the weights through ``update_weights``,
and on the CPU both run the same float32 ops in the same order.
"""

import http.server
import json
import logging
import os
import shutil
import threading
import time

import pytest
import torch

import rmnet_tpu_torch.eval_server as es
from rmnet_tpu_torch.config import Config
from rmnet_tpu_torch.data.synthetic import make_synthetic_davis
from rmnet_tpu_torch.models.weights import build_models
from rmnet_tpu_torch.parallel.eval_farm import AsyncDeviceFarm, DeviceFarm
from rmnet_tpu_torch.test import engine_from_cfg
from rmnet_tpu_torch.test import test_net as port_test_net
from rmnet_tpu_torch.utils.checkpoint import save_checkpoint
from rmnet_tpu_torch.utils.metrics import Metrics

from tests.test_torch_data import point_at

torch.set_num_threads(2)

LENGTHS, HW = (6, 4), (48, 64)
CPU = torch.device("cpu")
NAMES = ("ckpt-epoch-001.pth", "ckpt-epoch-002.pth", "ckpt-epoch-003.pth")


def _cfg(files, out="out"):
    cfg = Config()
    point_at(cfg, files["tree"])
    cfg.CONST.N_WORKERS = 2
    cfg.TEST.MEMORIZE_EVERY = 2
    cfg.TEST.N_MAX_OBJECTS = 2
    cfg.DIR.OUTPUT_DIR = str(files["root"] / out)
    cfg.CONST.EXP_NAME = "server"
    return cfg


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_server")
    tree = make_synthetic_davis(str(root / "davis"), n_videos=len(LENGTHS), n_frames=LENGTHS,
                                hw=HW)
    store = root / "store"
    for seed, name in enumerate(NAMES):
        rmnet, tfn = build_models(seed=seed, device="cpu")
        save_checkpoint(str(store), name, rmnet.state_dict(), tfn.state_dict(),
                        epoch_index=seed + 1)
    files = dict(root=root, tree=tree, store=store)
    cfg_file = root / "cfg.py"
    index_path, img_dir, ann_dir, flo_dir = tree
    cfg_file.write_text(
        "def configure(cfg):\n"
        f"    cfg.DATASETS.DAVIS.INDEXING_FILE_PATH = {index_path!r}\n"
        f"    cfg.DATASETS.DAVIS.IMG_FILE_PATH = {img_dir + '/%s/%05d.jpg'!r}\n"
        f"    cfg.DATASETS.DAVIS.ANNOTATION_FILE_PATH = {ann_dir + '/%s/%05d.png'!r}\n"
        f"    cfg.DATASETS.DAVIS.OPTICAL_FLOW_FILE_PATH = {flo_dir + '/%s/%05d.flo'!r}\n"
        f"    cfg.DIR.OUTPUT_DIR = {str(root / 'cli_out')!r}\n"
        "    cfg.CONST.EXP_NAME = 'cli'\n"
        "    cfg.CONST.N_WORKERS = 2\n"
        "    cfg.TEST.N_MAX_OBJECTS = 2\n"
        "    cfg.TEST.MEMORIZE_EVERY = 2\n")
    files["cfg_file"] = str(cfg_file)
    return files


@pytest.fixture(scope="module")
def reference_scores(files):
    """test_net on each checkpoint, each on a fresh engine."""
    out = {}
    for name in NAMES:
        cfg = _cfg(files)
        cfg.CONST.WEIGHTS = str(files["store"] / name)
        out[name] = port_test_net(cfg, engine=engine_from_cfg(cfg, device="cpu")).state_dict()
    return out


def _copy(files, tmp_path, names=NAMES):
    d = tmp_path / "ckpts"
    d.mkdir()
    for name in names:
        shutil.copy(files["store"] / name, d / name)
    return d


def _metrics(value):
    return Metrics(Config().TEST.MAIN_METRIC_NAME, [value] * len(Metrics.names()))


# ------------------------------------------------------------------ farm
def test_device_farm_map_preserves_order():
    seen = set()

    def work(device, item):
        seen.add(threading.get_ident())
        time.sleep(0.01 * (item % 3))
        return item * item

    assert DeviceFarm(work, [CPU] * 3).map(list(range(12))) == [i * i for i in range(12)]
    assert len(seen) >= 2


def test_farms_propagate_exceptions():
    def work(device, item):
        if item == 2:
            raise ValueError("bad item")
        return item

    with pytest.raises(ValueError, match="bad item"):
        DeviceFarm(work, [CPU] * 2).map(range(4))
    farm = AsyncDeviceFarm(work, [CPU])
    futures = [farm.submit(i) for i in range(4)]
    assert [f.result() for f in futures if f is not futures[2]] == [0, 1, 3]
    assert isinstance(futures[2].exception(), ValueError)
    farm.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        farm.submit(5)


def test_farm_defaults_to_the_card(files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceFarm(lambda d, x: x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        es.eval_server(_cfg(files, str(tmp_path)), str(_copy(files, tmp_path)),
                       max_iterations=1, keep_best_only=False)


# ---------------------------------------------------------- the server
def test_eval_server_scores_equal_test_net(files, reference_scores, tmp_path, monkeypatch):
    """Two CPU devices, three checkpoints: each scored as test_net scores it,
    one engine per device, the later checkpoints through update_weights; the
    curve logged at each checkpoint's own number; the best is the highest."""
    built, updates = [], []

    class Engine(es.InferenceEngine):
        def __init__(self, *args, **kwargs):
            built.append(threading.get_ident())
            super().__init__(*args, **kwargs)

        def update_weights(self, *args):
            updates.append(threading.get_ident())
            return super().update_weights(*args)

    monkeypatch.setattr(es, "InferenceEngine", Engine)
    cfg = _cfg(files, str(tmp_path))
    d = _copy(files, tmp_path)
    best, scores = es.eval_server(cfg, str(d), poll_seconds=0.0, max_iterations=1,
                                  keep_best_only=False, devices=[CPU, CPU])
    assert {os.path.basename(p): m.state_dict() for p, m in scores.items()} == reference_scores
    assert len(built) == len(set(built)) <= 2 and len(built) + len(updates) == len(NAMES)
    assert set(updates) <= set(built)
    jf = {os.path.basename(p): m.state_dict()["JF-Mean"] for p, m in scores.items()}
    assert os.path.basename(best) == max(sorted(jf), key=lambda k: jf[k])
    log = (tmp_path / "logs" / "server" / "eval_server" / "scalars.jsonl").read_text()
    steps = sorted(json.loads(line)["step"] for line in log.splitlines())
    assert steps == [1, 2, 3]
    assert sorted(os.listdir(d)) == sorted(NAMES)  # keep_best_only=False


def test_engine_is_reused_across_checkpoints(files, reference_scores, tmp_path, monkeypatch):
    """One device: one engine for every checkpoint, its later weights through
    update_weights under the same graphs and state (evaluate_checkpoints_farm)."""
    built = []

    class Engine(es.InferenceEngine):
        def __init__(self, *args, **kwargs):
            built.append(1)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(es, "InferenceEngine", Engine)
    paths = [str(files["store"] / n) for n in NAMES]
    got = es.evaluate_checkpoints_farm(_cfg(files, str(tmp_path)), paths, devices=[CPU])
    assert [m.state_dict() for m in got] == [reference_scores[n] for n in NAMES]
    assert built == [1]


def test_best_is_deterministic_on_ties_and_keep_best_only_prunes(files, tmp_path, monkeypatch):
    monkeypatch.setattr(es, "test_net", lambda *a, **k: _metrics(0.5))
    d = _copy(files, tmp_path)
    best, scores = es.eval_server(_cfg(files, str(tmp_path)), str(d), poll_seconds=0.0,
                                  max_iterations=1, devices=[CPU, CPU])
    assert len(scores) == 3
    assert os.path.basename(best) == NAMES[0]  # a tie goes to the earlier path
    assert os.listdir(d) == [NAMES[0]]  # the rest pruned


def test_checkpoint_that_fails_to_load_scores_none(files, tmp_path, monkeypatch, caplog):
    """A corrupt file, a state dict of another model and an orbax directory
    score None; the server goes on and scores the good one."""
    monkeypatch.setattr(es, "test_net", lambda *a, **k: _metrics(0.5))
    d = _copy(files, tmp_path, NAMES[:1])
    (d / "ckpt-corrupt.pth").write_bytes(b"not a checkpoint")
    rmnet, tfn = build_models(seed=0, device="cpu")
    rm_sd = rmnet.state_dict()
    rm_sd.pop("decoder.pred2.bias")
    save_checkpoint(str(d), "ckpt-other", rm_sd, tfn.state_dict())
    (d / "ckpt-orbax").mkdir()
    work = es._make_eval_worker(_cfg(files, str(tmp_path)), [])
    for name in ("ckpt-corrupt.pth", "ckpt-other.pth", "ckpt-orbax"):
        assert work(CPU, str(d / name)) is None
    with caplog.at_level(logging.INFO):
        best, scores = es.eval_server(_cfg(files, str(tmp_path)), str(d), poll_seconds=0.0,
                                      max_iterations=1, keep_best_only=True, devices=[CPU])
    assert [os.path.basename(p) for p in scores] == [NAMES[0]]
    assert os.path.basename(best) == NAMES[0]
    assert "decoder.pred2.bias" in caplog.text and "failed to load" in caplog.text
    assert sorted(os.listdir(d)) == sorted([NAMES[0], "ckpt-corrupt.pth", "ckpt-other.pth",
                                            "ckpt-orbax"])


def test_engine_failure_propagates(files, tmp_path, monkeypatch):
    """An exception in the engine's sweep stops the server (no retry on
    another read, no None score)."""
    def boom(*args, **kwargs):
        raise RuntimeError("engine fault")

    monkeypatch.setattr(es, "test_net", boom)
    with pytest.raises(RuntimeError, match="engine fault"):
        es.eval_server(_cfg(files, str(tmp_path)), str(_copy(files, tmp_path)),
                       poll_seconds=0.0, max_iterations=1, devices=[CPU])


def test_sweep_that_skips_a_video_raises(files, tmp_path, monkeypatch):
    """A sweep in which test_net skipped a video is not scored on fewer
    videos: it raises."""
    real = es.InferenceEngine.run_video_labels
    calls = []

    def flaky(self, *args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("one video fails")
        return real(self, *args)

    monkeypatch.setattr(es.InferenceEngine, "run_video_labels", flaky)
    with pytest.raises(RuntimeError, match="1 of 2 videos failed"):
        es.evaluate_checkpoints_farm(_cfg(files, str(tmp_path)),
                                     [str(files["store"] / NAMES[0])], devices=[CPU])


def test_eval_server_async_dispatch(files, tmp_path, monkeypatch):
    """A slow checkpoint on one device does not hold back a fast one on the
    other: the fast one is scored while the slow one is still loading."""
    release, fast_scored, slow_done = threading.Event(), threading.Event(), threading.Event()
    real_load = es.load_weights_auto

    def gated_load(path):
        if path.endswith(NAMES[0]):
            assert release.wait(timeout=30), "test deadlock"
            slow_done.set()
        return real_load(path)

    def fake_test_net(*args, **kwargs):
        fast_scored.set()
        return _metrics(0.5)

    class Engine:
        def __init__(self, *args, **kwargs):
            pass

        def update_weights(self, *args):
            pass

    monkeypatch.setattr(es, "load_weights_auto", gated_load)
    monkeypatch.setattr(es, "test_net", fake_test_net)
    monkeypatch.setattr(es, "InferenceEngine", Engine)
    stop = threading.Event()
    result = {}
    d = _copy(files, tmp_path, NAMES[:2])
    th = threading.Thread(target=lambda: result.setdefault("out", es.eval_server(
        _cfg(files, str(tmp_path)), str(d), poll_seconds=0.02, keep_best_only=False,
        stop_event=stop, devices=[CPU, CPU])), daemon=True)
    th.start()
    assert fast_scored.wait(timeout=60), "the fast checkpoint was never scored"
    assert not slow_done.is_set(), "the slow checkpoint finished first: not asynchronous"
    time.sleep(0.1)  # the poll loop harvests the fast one
    release.set()
    stop.set()
    th.join(timeout=60)
    assert not th.is_alive()
    _, scores = result["out"]
    assert sorted(os.path.basename(p) for p in scores) == list(NAMES[:2])  # drained


def test_stop_cancels_the_backlog(files, tmp_path, monkeypatch):
    """A stop request cancels the checkpoints still queued; the one in
    flight finishes."""
    release, started = threading.Event(), threading.Event()
    evaluated = []

    def work(device, path):
        started.set()
        assert release.wait(timeout=30), "test deadlock"
        evaluated.append(os.path.basename(path))
        return _metrics(0.5)

    monkeypatch.setattr(es, "_make_farm", lambda cfg, devices: AsyncDeviceFarm(work, [CPU]))
    stop = threading.Event()
    result = {}
    th = threading.Thread(target=lambda: result.setdefault("out", es.eval_server(
        _cfg(files, str(tmp_path)), str(_copy(files, tmp_path)), poll_seconds=0.02,
        keep_best_only=False, stop_event=stop)), daemon=True)
    th.start()
    assert started.wait(timeout=30)
    stop.set()
    time.sleep(1.0)  # the loop wakes and cancels the queue before the first one ends
    release.set()
    th.join(timeout=30)
    assert not th.is_alive()
    assert evaluated == [NAMES[0]]
    assert len(result["out"][1]) == 1


def test_remote_checkpoints_are_fetched(files, reference_scores, tmp_path):
    """--remote: .pth files linked from an HTTP directory listing (an
    http.server on 127.0.0.1 in a thread) are downloaded and scored."""
    served = _copy(files, tmp_path, NAMES[1:])

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, directory=str(served), **kwargs)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        local = tmp_path / "local"
        best, scores = es.eval_server(
            _cfg(files, str(tmp_path)), str(local), poll_seconds=0.0, max_iterations=1,
            keep_best_only=False, devices=[CPU],
            remote_url=f"http://127.0.0.1:{server.server_address[1]}/")
    finally:
        server.shutdown()
        server.server_close()
    assert sorted(os.listdir(local)) == list(NAMES[1:])
    assert {os.path.basename(p): m.state_dict() for p, m in scores.items()} == {
        n: reference_scores[n] for n in NAMES[1:]}


def test_runner_eval_server(files, reference_scores, tmp_path, caplog):
    """python -m rmnet_tpu_torch.runner --eval-server --ckpt-dir in process,
    one poll: every checkpoint evaluated and logged with test_net's scores."""
    from rmnet_tpu_torch.runner import main

    d = _copy(files, tmp_path)
    with caplog.at_level(logging.INFO):
        main(["--device", "cpu", "--cfg", files["cfg_file"], "--eval-server", "--ckpt-dir",
              str(d), "--max-iterations", "1", "--poll-seconds", "0"])
    lines = {r.getMessage() for r in caplog.records if r.getMessage().startswith("Evaluated ")}
    assert lines == {f"Evaluated {n}: {reference_scores[n]}" for n in NAMES}
    best = max(NAMES, key=lambda n: (reference_scores[n]["JF-Mean"], -NAMES.index(n)))
    assert os.listdir(d) == [best]  # the runner keeps the best only
