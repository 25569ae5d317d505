"""Readings that the limits of ``correct`` are set from, many seeds in one
process: the program's gap to the reference on the timed path at the cell's
own sizes, and the control's, the reference computed in the precision below
the configuration's (streams: float8 e4m3 operands for every convolution and
the read, against bfloat16; training: the program's own TRAIN.BF16 path,
against float32), witnesses (the reference itself in the configuration's
precision: bfloat16 operands for streams, TF32 for training), and for
training the faults of half the batch left out and of a wrong dQ in the
read's backward.

    python3 -m vosbench.calibrate --workload <cell> --seeds 1,2,3 --control-seeds 1,2,3 \
        [--witness-seeds 1] [--free-frames 16] [--no-judge]

prints one JSON line per seed: for streams each video's per-frame gaps
(teacher-forced, and free-running over the first frames), for training
each run's numbers, losses, per-frame estimate gaps and per-leaf norms. Needs the card; the benchmark's runs never
run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from vosbench import harness, inputs, manifest
from vosbench.reference import rmnet_ref


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def _r(values):
    return [float(f"{v:.5g}") for v in values]


def stream(cell, seeds, control_seeds, dev, n_free, judged, witness_seeds=None):
    S = manifest.driver("stream")
    c, tr = cell.config, cell.traffic
    T, H, W = tr["frames"], c["frame_height"], c["frame_width"]
    n_free = min(n_free or T - 1, T - 1)
    engine = None
    for seed in seeds:
        t0 = time.perf_counter()
        rm_sd, tfn_sd = inputs.weights(seed, dev, c["bbox_loose_pixels"],
                                       c["n_pts_threshold"], c["prob_threshold"])
        clips = [inputs.stream_clip(seed, i, T, H, W, tr["appear"], dev, tr.get("object_size"))
                 for i in range(tr["sampled_videos"])]
        if engine is None:
            engine = S.make_engine(c, rm_sd, tfn_sd, dev)
            engine.run_video(*clips[0])
        else:
            engine.update_weights(rm_sd, tfn_sd)
        probs = [engine.run_video(*clip) for clip in clips]
        rm, tfn = rmnet_ref.on_device(rm_sd, tfn_sd, dev, c["bbox_loose_pixels"],
                                      c["n_pts_threshold"], c["prob_threshold"])
        row = dict(seed=seed, program=[], witness=[], control=[])
        stop = None if judged else n_free + 1
        with harness.no_tf32():
            for clip, p in zip(clips, probs):
                runs = [("program", torch.from_numpy(p).to(dev))]
                quants = []
                if witness_seeds is None or seed in witness_seeds:
                    # a witness: the reference itself with bfloat16 operands
                    quants.append(("witness", rmnet_ref.bf16_round))
                if seed in control_seeds:  # the control in the program's place
                    quants.append(("control", rmnet_ref.fp8_e4m3))
                for key, quant in quants:
                    with rmnet_ref.computed_in(quant, rm, tfn):
                        runs.append((key, rmnet_ref.infer(
                            rm, tfn, *S._video(clip, dev), c["memorize_every"], stop=stop)))
                for key, run in runs:
                    rec = dict(free=_r(S.free_gaps(c, rm, tfn, clip, run, n_free, dev)))
                    if judged:
                        rec["gap"] = _r(S.judge_run(c, rm, tfn, clip, run, dev))
                    row[key].append(rec)
                del runs
        del rm, tfn
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)


def train(cell, seeds, control_seeds, dev):
    import rmnet_tpu_torch.ops.flash_attention as fa
    from rmnet_tpu_torch.train import Trainer

    D = manifest.driver("train")
    c, tr = cell.config, cell.traffic
    torch.backends.cudnn.allow_tf32 = c["tf32_cudnn"]
    torch.backends.cuda.matmul.allow_tf32 = c["tf32_matmul"]
    n = tr["reference_steps"]
    B = c["batch_size"]
    names = None
    for seed in seeds:
        t0 = time.perf_counter()
        rm_sd, tfn_sd = inputs.weights(seed, dev)
        pool = D.make_pool(c, dict(tr, pool=n), seed, dev)
        p0 = {k: v.detach().cpu() for k, v in rm_sd.items()}

        def program(conf, half=False, dq_scale=None):
            trainer = Trainer(D.make_config(conf), rm_sd, tfn_sd, device=dev)
            if half:  # the fault: half the batch left out, the mean over the rest
                step = trainer._step
                trainer._step = lambda batch, lr: step({k: v[:B // 2] for k, v in batch.items()},
                                                       lr)
            real = fa.flash_read_bwd
            if dq_scale is not None:  # the fault: the read's backward gives a wrong dQ
                def wrong(*args):
                    dq, dk, dv = real(*args)
                    return dq * dq_scale, dk, dv
                wrong.launches = real.launches  # the kernel's wrapper counts on its name
                fa.flash_read_bwd = wrong
            try:
                out = D.first_steps(trainer, pool, n, c["betas"][0])
            finally:
                if fa.flash_read_bwd is not real:
                    real.launches = fa.flash_read_bwd.launches
                fa.flash_read_bwd = real
            del trainer
            torch.cuda.empty_cache()
            return out

        def detail(run, ref):
            """The numbers, and per leaf the norms of the first gradient and
            of the change, per frame the first step's estimate gaps."""
            num = D.compare(run, ref, p0)
            g = D._norms(run[1])
            ch = D._norms({k: run[2][k] - p0[k] for k in run[2]})
            return dict(num, losses=run[0], est_gaps=_r(D.est_gaps(run[3], ref[3])),
                        grad_norms=_r([g[k] for k in names]),
                        change_norms=_r([ch[k] for k in names]))

        faults = seed in control_seeds
        runs = dict(program=program(c))
        if faults:
            runs["control"] = program(dict(c, bf16=True))
            runs["fault_half_batch"] = program(c, half=True)
            runs["fault_read_dq_x1.5"] = program(c, dq_scale=1.5)
        ref = D.reference_steps(c, rm_sd, pool, n, dev)
        # a witness: the reference itself at the configuration's TF32
        runs["witness_tf32"] = D.reference_steps(c, rm_sd, pool, n, dev, tf32=True)
        row = dict(seed=seed)
        if names is None:
            names = list(ref[1])
            row["leaves"] = names
        gr = D._norms(ref[1])
        cr = D._norms({k: ref[2][k] - p0[k] for k in names})
        row["reference"] = dict(losses=ref[0], grad_norms=_r([gr[k] for k in names]),
                                change_norms=_r([cr[k] for k in names]))
        for key, run in runs.items():
            row[key] = detail(run, ref)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del runs, ref
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--witness-seeds", type=_seeds, default=None)
    ap.add_argument("--free-frames", type=int, default=0)
    ap.add_argument("--no-judge", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness.cache_dirs()
    cell = manifest.cell(args.workload)
    dev = torch.device(args.device)
    print(json.dumps(dict(workload=args.workload, device=harness.device_info(dev))), flush=True)
    if cell.driver == "stream":
        stream(cell, args.seeds, set(args.control_seeds), dev, args.free_frames,
               not args.no_judge,
               None if args.witness_seeds is None else set(args.witness_seeds))
    else:
        train(cell, args.seeds, set(args.control_seeds), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
