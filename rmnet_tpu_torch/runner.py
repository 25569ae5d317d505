"""Command line of the port (counterpart of rmnet_tpu/runner.py, reference
runner.py:28-109).

    python -m rmnet_tpu_torch.runner --cfg CFG.py --test --weights CKPT.pth
    python -m rmnet_tpu_torch.runner --cfg CFG.py --inference --weights CKPT.pth

The config is a Python file defining ``configure(cfg)`` or a ``CFG`` dict
(``--cfg``), then ``--set PATH=VALUE`` overrides. Everything runs on the card
unless ``--device cpu``. Training and ``--eval-server`` are not ported yet
(ROADMAP queue 1 items 2 and 3) and exit with a message saying so.
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
        sys.exit("rmnet_tpu_torch.runner: the eval server is not ported yet "
                 "(ROADMAP queue 1 item 3)")
    if not args.test and not args.inference:
        sys.exit("rmnet_tpu_torch.runner: training (train_net) is not ported yet "
                 "(ROADMAP queue 1 item 2); pass --test or --inference")
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
