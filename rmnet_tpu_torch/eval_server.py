"""Continuous checkpoint evaluation (counterpart of rmnet_tpu/core/eval_server.py;
reference utils/eval_server.py:129-263).

``eval_server`` watches a checkpoint directory (optionally filled from an
HTTP directory listing, ``remote_url``), submits every new checkpoint to a
per-device farm without waiting (``AsyncDeviceFarm``), harvests finished
evaluations on each poll, logs the main metric at the checkpoint's own
number, keeps a deterministic best (strictly greater wins; a tie goes to
the earlier path) and, with ``keep_best_only``, deletes the others.
``stop_event`` ends the loop: checkpoints still queued are cancelled, those
in flight finish.

Each device keeps one InferenceEngine (its CUDA graphs captured once per
geometry) for the server's life, and takes each checkpoint's weights through
``update_weights``; it reads through the flash kernel, as every engine does.
A checkpoint that fails to load (a corrupt file, another model, an orbax
directory of the JAX package) scores None and the server goes on, as the
reference skips it. Anything that fails in the engine's sweep propagates
and stops the server: there is no retry on another read, and a sweep that
skipped a video raises rather than score on fewer videos.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional, Sequence, Set

import torch

from rmnet_tpu_torch.data import DataLoader, DatasetCollector, DatasetSubset
from rmnet_tpu_torch.engine import InferenceEngine
from rmnet_tpu_torch.models.rmnet import RMNet
from rmnet_tpu_torch.models.tiny_flownet import TinyFlowNet
from rmnet_tpu_torch.parallel.eval_farm import AsyncDeviceFarm, DeviceFarm
from rmnet_tpu_torch.test import EvalStats, test_net
from rmnet_tpu_torch.utils.checkpoint import load_weights_auto
from rmnet_tpu_torch.utils.metrics import Metrics
from rmnet_tpu_torch.utils.summary import SummaryWriter


def get_checkpoints(ckpt_dir: str, evaluated: Set[str]):
    """New checkpoint paths in the directory (``ckpt*.pth`` files, and
    ``ckpt*`` directories, which fail to load), in name order."""
    fresh = []
    if not os.path.isdir(ckpt_dir):
        return fresh
    for entry in sorted(os.listdir(ckpt_dir)):
        path = os.path.join(ckpt_dir, entry)
        if entry in evaluated or entry.startswith("."):
            continue
        if entry.startswith("ckpt") and (os.path.isdir(path) or entry.endswith(".pth")):
            fresh.append(path)
    return fresh


def fetch_remote_checkpoints(url: str, local_dir: str, evaluated: Set[str]):
    """Download the ``.pth`` files that an HTTP directory listing at ``url``
    links to (anchor hrefs) into ``local_dir``, but those already evaluated
    or present -> their local paths (reference utils/eval_server.py:129-144)."""
    import urllib.request

    os.makedirs(local_dir, exist_ok=True)
    with urllib.request.urlopen(url) as resp:
        html = resp.read().decode("utf-8", "replace")
    fetched = []
    for name in sorted(set(re.findall(r'href="([^"]+\.pth)"', html))):
        base = os.path.basename(name)
        if base in evaluated:
            continue
        dest = os.path.join(local_dir, base)
        if not os.path.exists(dest):
            logging.info("Downloading remote checkpoint %s", base)
            tmp = dest + ".part"
            urllib.request.urlretrieve(url.rstrip("/") + "/" + name, tmp)
            os.replace(tmp, dest)
        fetched.append(dest)
    return fetched


def eval_server(cfg, ckpt_dir: str, poll_seconds: float = 15.0, keep_best_only: bool = True,
                max_iterations: Optional[int] = None, remote_url: Optional[str] = None,
                stop_event=None, devices: Optional[Sequence[torch.device]] = None):
    """Evaluate every new checkpoint of ``ckpt_dir`` until ``max_iterations``
    polls (None: for ever) or ``stop_event`` -> (best path, {path: Metrics}).
    ``devices`` default to every CUDA device; raises without one."""
    log_dir = os.path.join(cfg.DIR.OUTPUT_DIR, "logs", cfg.CONST.EXP_NAME)
    writer = SummaryWriter(log_dir, "eval_server")
    main = cfg.TEST.MAIN_METRIC_NAME
    evaluated: Set[str] = set()
    scores: Dict[str, Metrics] = {}
    pending: Dict[str, Any] = {}     # path -> Future
    submit_idx: Dict[str, int] = {}  # path -> submission order
    best_path: Optional[str] = None
    farm = None

    def ckpt_step(path):
        # the checkpoint's own number (ckpt-epoch-NNN), so that the order in
        # which evaluations finish cannot scramble the curve; a name without
        # digits takes its submission index
        m = re.search(r"(\d+)(?!.*\d)", os.path.basename(path))
        return int(m.group(1)) if m else submit_idx[path]

    def record(path, metrics):
        nonlocal best_path
        if metrics is None:  # a checkpoint that did not load
            return
        scores[path] = metrics
        jf = metrics.state_dict()[main]
        writer.add_scalar(f"EvalServer/{main}", jf, ckpt_step(path))
        logging.info("Evaluated %s: %s", os.path.basename(path), metrics)
        if best_path is None:
            best_path = path
        else:
            best_jf = scores[best_path].state_dict()[main]
            if jf > best_jf or (jf == best_jf and path < best_path):
                best_path = path

    def harvest():
        for path in [p for p, f in pending.items() if f.done()]:
            record(path, pending.pop(path).result())

    def prune():
        if not keep_best_only:
            return
        for p in list(scores):
            if p != best_path and os.path.exists(p):
                shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
                logging.info("Removed non-best checkpoint %s", p)

    def stopped():
        return stop_event is not None and stop_event.is_set()

    iteration = 0
    try:
        while (max_iterations is None or iteration < max_iterations) and not stopped():
            iteration += 1
            if remote_url:
                try:
                    fetch_remote_checkpoints(remote_url, ckpt_dir, evaluated)
                except OSError as ex:  # the remote is down: poll again later
                    logging.warning("remote checkpoint fetch failed: %s", ex)
            fresh = get_checkpoints(ckpt_dir, evaluated)
            evaluated.update(os.path.basename(p) for p in fresh)
            if fresh and farm is None:
                farm = _make_farm(cfg, devices)
            for path in fresh:
                submit_idx[path] = len(submit_idx)
                pending[path] = farm.submit(path)
            harvest()
            prune()
            if (max_iterations is None or iteration < max_iterations) and not stopped():
                if stop_event is not None:
                    stop_event.wait(poll_seconds)
                else:
                    time.sleep(poll_seconds)
        # drain: on a stop request the queued evaluations are cancelled first,
        # then those in flight are waited for
        cancelled = {p for p, f in pending.items() if f.cancel()} if stopped() else set()
        for path in list(pending):
            future = pending.pop(path)
            if path not in cancelled:
                record(path, future.result())
        prune()
    finally:
        for future in pending.values():  # an evaluation raised: run no more
            future.cancel()
        if farm is not None:
            farm.shutdown()
        writer.close()
    return best_path, scores


def _check_state(state, template, what):
    """Raise unless ``state`` has ``template``'s keys and shapes."""
    if set(state) != set(template):
        missing, extra = sorted(set(template) - set(state)), sorted(set(state) - set(template))
        raise ValueError(f"{what}: missing {missing[:5]}, unexpected {extra[:5]}")
    bad = [k for k, v in state.items() if tuple(v.shape) != tuple(template[k].shape)]
    if bad:
        raise ValueError(f"{what}: shapes differ at {bad[:5]}")


def _make_eval_worker(cfg, dataset):
    """The farm's work function (device, checkpoint path) -> Metrics, or None
    when the checkpoint fails to load. One engine per farm thread, that is
    per device, built at the thread's first checkpoint and given each later
    one through ``update_weights``; the sweep is test_net's standalone one
    over ``dataset``."""
    with torch.device("meta"):
        templates = (RMNet().state_dict(), TinyFlowNet().state_dict())
    mine = threading.local()  # .engine: this thread's InferenceEngine

    def work(device, path):
        try:
            rm_sd, tfn_sd, _ = load_weights_auto(path)
            _check_state(rm_sd, templates[0], f"{path}: RMNet")
            _check_state(tfn_sd, templates[1], f"{path}: TinyFlowNet")
        except Exception:  # skip the checkpoint (reference utils/eval_server.py:111-114)
            logging.exception("checkpoint %s failed to load: not scored", path)
            return None
        engine = getattr(mine, "engine", None)
        if engine is None:
            mine.engine = engine = InferenceEngine(cfg, rm_sd, tfn_sd, device=device)
        else:
            engine.update_weights(rm_sd, tfn_sd)
        loader = DataLoader(dataset, batch_size=1, shuffle=False,
                            n_workers=cfg.CONST.N_WORKERS)
        stats = EvalStats()
        metrics = test_net(cfg, -1, loader, None, engine, stats=stats)
        if stats.skipped or stats.batch_fallbacks:
            raise RuntimeError(f"{path}: {stats.skipped} of {stats.attempted} videos failed "
                               f"and {stats.batch_fallbacks} batches were served again; "
                               f"not scored on fewer videos ({stats})")
        return metrics

    return work


def _val_dataset(cfg):
    return DatasetCollector.get_dataset(cfg, cfg.DATASET.TEST_DATASET, DatasetSubset.VAL)


def _make_farm(cfg, devices=None) -> AsyncDeviceFarm:
    return AsyncDeviceFarm(_make_eval_worker(cfg, _val_dataset(cfg)), devices)


def evaluate_checkpoints_farm(cfg, paths, devices=None):
    """Score ``paths`` across the devices, one engine per device -> a list of
    Metrics (None where a checkpoint failed to load), in input order."""
    return DeviceFarm(_make_eval_worker(cfg, _val_dataset(cfg)), devices).map(paths)
