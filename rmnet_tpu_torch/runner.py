"""Command line of the port (counterpart of rmnet_tpu/runner.py, reference
runner.py:28-109).

    python -m rmnet_tpu_torch.runner --cfg CFG.py --exp NAME [--weights CKPT.pth]
    python -m rmnet_tpu_torch.runner --cfg CFG.py --test --weights CKPT.pth
    python -m rmnet_tpu_torch.runner --cfg CFG.py --inference --weights CKPT.pth
    python -m rmnet_tpu_torch.runner --cfg CFG.py --eval-server [--ckpt-dir DIR] [--remote URL]

Without ``--test`` or ``--inference`` it trains (``train_net``); with
``--weights`` a training run starts from that checkpoint and, when it holds
the full state (``ckpt-interrupt.pth``, ``ckpt-epoch-*.pth``), resumes its
epoch and Adam state. SIGTERM or SIGINT stops a training run after its batch
with ``ckpt-interrupt.pth`` saved, and the process exits 0. The config is a
Python file defining ``configure(cfg)`` or a ``CFG`` dict (``--cfg``), then
``--set PATH=VALUE`` overrides. Everything runs on the card unless
``--device cpu``. ``--eval-server`` scores every new checkpoint of
``--ckpt-dir`` (default ``OUTPUT_DIR/checkpoints/EXP_NAME``), optionally
downloaded from the HTTP directory listing ``--remote``, on every CUDA
device (or ``--device``), polling every ``--poll-seconds`` for
``--max-iterations`` polls (default: until SIGTERM or SIGINT, after which
the checkpoints in flight finish and the process exits 0).
"""

from __future__ import annotations

import argparse
import logging
import random
import sys

import numpy as np
import torch


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="rmnet_tpu_torch runner")
    parser.add_argument("--exp", dest="exp_name", default=None, type=str)
    parser.add_argument("--cfg", dest="cfg_file", default=None, type=str,
                        help="Python file defining configure(cfg) or CFG dict")
    parser.add_argument("--rand", dest="randomize", action="store_true",
                        help="Randomize (do not use a fixed seed)")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--inference", action="store_true")
    parser.add_argument("--eval-server", dest="eval_server", action="store_true")
    parser.add_argument("--ckpt-dir", dest="ckpt_dir", default=None, type=str)
    parser.add_argument("--remote", default=None, type=str,
                        help="HTTP directory URL to scrape for new .pth checkpoints "
                             "(eval-server mode)")
    parser.add_argument("--poll-seconds", dest="poll_seconds", default=15.0, type=float,
                        help="eval-server mode: seconds between polls")
    parser.add_argument("--max-iterations", dest="max_iterations", default=None, type=int,
                        help="eval-server mode: polls before it returns (default: no limit)")
    parser.add_argument("--weights", default=None, type=str)
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="PATH=VALUE", help="config override, repeatable")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device of the engine (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    from rmnet_tpu_torch.config import Config

    args = get_args(argv)
    cfg = Config.from_file(args.cfg_file)
    cfg.apply_overrides(args.overrides)

    if not args.randomize:
        random.seed(cfg.CONST.RNG_SEED)
        np.random.seed(cfg.CONST.RNG_SEED)
        torch.manual_seed(cfg.CONST.RNG_SEED)
    if args.exp_name is not None:
        cfg.CONST.EXP_NAME = args.exp_name
    if args.weights is not None:
        cfg.CONST.WEIGHTS = args.weights

    if args.eval_server:
        from rmnet_tpu_torch.eval_server import eval_server
        from rmnet_tpu_torch.utils.signals import stop_on_signals

        ckpt_dir = args.ckpt_dir or f"{cfg.DIR.OUTPUT_DIR}/checkpoints/{cfg.CONST.EXP_NAME}"
        devices = None if args.device == "cuda" else [torch.device(args.device)]
        with stop_on_signals("finishing the checkpoints in flight, then exiting") as stop:
            eval_server(cfg, ckpt_dir, poll_seconds=args.poll_seconds,
                        max_iterations=args.max_iterations, remote_url=args.remote,
                        stop_event=stop, devices=devices)
        return
    if not args.test and not args.inference:
        from rmnet_tpu_torch.train import NETWORKS, train_net

        if cfg.TRAIN.NETWORK not in NETWORKS:
            logging.error("Unknown network %s; TRAIN.NETWORK is one of %s.",
                          cfg.TRAIN.NETWORK, NETWORKS)
            sys.exit(1)
        train_net(cfg, device=args.device)
        return
    if not cfg.CONST.WEIGHTS:
        logging.error("Please specify the file path of checkpoint (--weights).")
        sys.exit(2)
    if args.test:
        from rmnet_tpu_torch.test import test_net

        test_net(cfg, device=args.device)
    else:
        from rmnet_tpu_torch.inference import inference_net

        inference_net(cfg, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(format="[%(levelname)s] %(asctime)s %(message)s", level=logging.INFO)
    main()
