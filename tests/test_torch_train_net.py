"""The port's training orchestration against the JAX package's, on the CPU:
``train_net``, REMAT, GRAD_ACCUM_STEPS, the refused flags, backbone init,
full-state checkpoints, SIGTERM and resume, and the skip rules.

One synthetic DAVIS tree (48x64, videos of 6 and 4 frames) and one
reference-format .pth of the port's seeded random weights (imported into
JAX variables and converted back, so both packages load the same numbers).
``train_net`` runs one epoch in each package from that .pth (CONST.WEIGHTS):
B = 2, T = 2, 48x48 crops, two batches, REMAT "none" (the modes are held
equal to each other below), the JAX package with its dense read, the port
with the plain version of the flash read.

Tolerances. The packages' losses agree to about 1e-6 relative (float32
convolutions summed in another order), so per-batch losses are held to
1e-5. Adam normalises each update to about lr per element, and where a
gradient is near zero its sign follows those last bits. So the saved
weights are held per tensor: a tensor that moved by at least a tenth of
Adam's usual lr * steps * sqrt(size) has a gradient that is not zero, and
its difference to the JAX package's is held to 2e-2 of its update's norm
(measured: at most 6.4e-3, median 2.4e-5; 295 of the 296 tensors). The one
left out is the memory key's bias, whose exact gradient is 0 under the
softmax (q·b adds the same logit to a whole row), so it moves by sign
noise alone (measured: 5e-4 of the usual update). Over the network the
difference is held to 2e-3 of the update's norm (measured: 5e-4). The best JF at 1e-4: the two reads agree to about 1e-6,
and one label near a tie moves the score of these 48x64 videos by 1e-5 to
1e-4 (tests/test_torch_eval.py holds the same scores to 1e-5 before
training).
"""

import dataclasses
import os
import random
import re
import shutil
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmnet_tpu.config import Config as JaxConfig
from rmnet_tpu.core import train as jax_train
from rmnet_tpu.data import datasets as jax_datasets
from rmnet_tpu.models.rmnet import RMNet as JaxRMNet
from rmnet_tpu.models.tiny_flownet import TinyFlowNet as JaxTinyFlowNet
from rmnet_tpu.utils.checkpoint import load_backbone_weights as jax_load_backbone_weights
from rmnet_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from rmnet_tpu.utils.checkpoint import load_weights_auto as jax_load_weights_auto

from rmnet_tpu_torch import train as port_train
from rmnet_tpu_torch.config import Config
from rmnet_tpu_torch.data import datasets as port_datasets
from rmnet_tpu_torch.data.synthetic import make_synthetic_davis
from rmnet_tpu_torch.models.weights import build_models, from_jax_variables
from rmnet_tpu_torch.train import (TrainStats, Trainer, adam_summary, make_loss_fn,
                                   make_optimizer, make_train_step, train_net)
from rmnet_tpu_torch.utils.checkpoint import (load_backbone_weights, load_weights_auto,
                                              save_checkpoint)

from tests.test_torch_data import point_at
from tests.test_torch_engine import _jax_variables
from tests.test_torch_train import _clip

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, LENGTHS, CROP = (48, 64), (6, 4), 48
LR = 1e-5


def _configure(cfg, files, out, **train):
    point_at(cfg, files["tree"])
    aug = cfg.TRAIN.AUGMENTATION
    aug.RESIZE_SIZE, aug.CROP_HSIZE, aug.CROP_WSIZE = CROP, CROP, CROP
    cfg.DATASET.TRAIN_DATASET = ["DAVISx2"]
    tr = cfg.TRAIN
    tr.BATCH_SIZE, tr.N_MAX_FRAMES, tr.N_MAX_OBJECTS, tr.N_EPOCHS = 2, 2, 2, 1
    tr.REMAT, tr.LEARNING_RATE, tr.CKPT_SAVE_THRESHOLD = "none", LR, -1.0
    for k, v in train.items():
        setattr(tr, k, v)
    cfg.TEST.TESTING_VIDEOS_INDEXES = (0,)
    cfg.TEST.MEMORIZE_EVERY = 2
    cfg.TEST.VISUALIZE_EVERY = 0
    cfg.CONST.N_WORKERS = 2
    cfg.CONST.WEIGHTS = files["pth"]
    cfg.DIR.OUTPUT_DIR = str(out)
    return cfg


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_net")
    tree = make_synthetic_davis(str(root / "davis"), n_videos=len(LENGTHS), n_frames=LENGTHS,
                                hw=HW)
    rmnet, tfn = build_models(seed=0, device="cpu")
    rm_vars = _jax_variables(JaxRMNet(), rmnet.state_dict(), jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 32, 32)), jnp.zeros((1, 32, 32)))
    tfn_vars = _jax_variables(JaxTinyFlowNet(), tfn.state_dict(), jnp.zeros((1, 2, 64, 64, 3)))
    states = from_jax_variables(rm_vars, tfn_vars)
    pth = save_checkpoint(str(root), "init", *states)
    return dict(root=root, tree=tree, pth=pth, states=states, rm_vars=rm_vars,
                tfn_vars=tfn_vars)


def _run(package, files, out, **train):
    """One train_net run of ``package`` ("jax" or "port") -> (best metrics,
    per-batch losses, frame steps set, its config). The working directory
    is the run's own, so the code snapshot zips nothing of the checkout."""
    mod = jax_train if package == "jax" else port_train
    cfg = _configure(JaxConfig() if package == "jax" else Config(), files, out, **train)
    losses, steps = [], []
    with pytest.MonkeyPatch.context() as mp:
        os.makedirs(out, exist_ok=True)
        mp.chdir(out)
        real = mod.SummaryWriter.add_scalar

        def add_scalar(self, tag, value, step=None):
            if tag == "Loss/Batch":
                losses.append(float(value))
            return real(self, tag, value, step)

        mp.setattr(mod.SummaryWriter, "add_scalar", add_scalar)
        multiple = (jax_datasets if package == "jax" else port_datasets).MultipleDatasets
        real_step = multiple.set_frame_step
        mp.setattr(multiple, "set_frame_step",
                   lambda self, s: (steps.append(s), real_step(self, s))[1])
        if package == "jax":
            # the weights come from CONST.WEIGHTS: skip compiling the JAX init
            mp.setattr(mod, "build_models", lambda cfg, seed, dtype=None: (
                JaxRMNet(), JaxTinyFlowNet(), jax.tree_util.tree_map(np.zeros_like, files["rm_vars"]),
                jax.tree_util.tree_map(np.zeros_like, files["tfn_vars"])))
            random.seed(5)
            best = mod.train_net(cfg)
        else:
            random.seed(5)
            best = mod.train_net(cfg, device="cpu")
    return best, losses, steps, cfg


@pytest.fixture(scope="module")
def runs(files):
    out = {p: _run(p, files, files["root"] / f"out_{p}") for p in ("port", "jax")}
    yield out
    for _, _, _, cfg in out.values():
        shutil.rmtree(_ckpt_dir(cfg))


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A checkpoint holds the weights and Adam's moments, about 0.5 GB:
    each test's own go when it ends."""
    yield
    for path in tmp_path.rglob("*.pth"):
        path.unlink()


def _ckpt_dir(cfg):
    return os.path.join(cfg.DIR.OUTPUT_DIR, "checkpoints", cfg.CONST.EXP_NAME)


def test_train_net_matches_jax(runs, files):
    (best, losses, steps, cfg), (best_j, losses_j, steps_j, cfg_j) = runs["port"], runs["jax"]
    assert len(losses) == len(losses_j) == 2 and steps == steps_j and len(steps) == 1
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
    jf, jf_j = (b.state_dict()["JF-Mean"] for b in (best, best_j))
    assert abs(jf - jf_j) <= 1e-4
    # the saved weights: the port's ckpt-best.pth against the JAX package's
    rm_sd, _, extras = load_weights_auto(os.path.join(_ckpt_dir(cfg), "ckpt-best.pth"))
    state_j = jax_load_checkpoint(os.path.join(_ckpt_dir(cfg_j), "ckpt-best"))
    rm_j, _ = from_jax_variables(state_j["rmnet"], state_j["tflownet"])
    init = files["states"][0]
    assert extras["epoch"] == 1 and extras["best_metrics"] == best.state_dict()
    n_steps, diff2, update2, held = len(losses), 0.0, 0.0, 0
    for key, w_j in rm_j.items():
        if not key.endswith(("weight", "bias")):
            continue
        w, w_j, w0 = rm_sd[key].numpy(), w_j.numpy(), init[key].numpy()
        diff, update = float(np.linalg.norm(w - w_j)), float(np.linalg.norm(w_j - w0))
        if update >= 0.1 * LR * n_steps * w.size ** 0.5:
            assert diff <= 2e-2 * update, key
            held += 1
        diff2 += diff ** 2
        update2 += update ** 2
    assert held >= 290 and diff2 ** 0.5 <= 2e-3 * update2 ** 0.5


def test_train_net_outputs(runs):
    best, _, _, cfg = runs["port"]
    ckpt_dir = _ckpt_dir(cfg)
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt-best.pth", "ckpt-epoch-001.pth"]
    ckpt = torch.load(os.path.join(ckpt_dir, "ckpt-epoch-001.pth"), weights_only=True)
    assert set(ckpt) == {"epoch_index", "best_metrics", "rmnet", "tflownet", "optimizer"}
    steps = {int(s["step"]) for s in ckpt["optimizer"]["state"].values()}
    assert steps == {2}
    assert os.path.exists(os.path.join(cfg.DIR.OUTPUT_DIR, "snapshots", "default.zip"))
    logs = os.path.join(cfg.DIR.OUTPUT_DIR, "logs", "default")
    assert os.path.exists(os.path.join(logs, "train", "scalars.jsonl"))
    assert "JF-Mean" in open(os.path.join(logs, "test", "scalars.jsonl")).read()


def test_tinyflownet_training_changes_only_tinyflownet(files, tmp_path):
    _, losses, _, cfg = _run("port", files, tmp_path, NETWORK="TinyFlowNet")
    assert len(losses) == 2 and all(np.isfinite(losses))
    rm_sd, tfn_sd, _ = load_weights_auto(os.path.join(_ckpt_dir(cfg), "ckpt-best.pth"))
    rm0, tfn0 = files["states"]
    assert all(torch.equal(rm_sd[k], v) for k, v in rm0.items())
    changed = [k for k, v in tfn0.items() if not torch.equal(tfn_sd[k], v)]
    assert len(changed) > 10


# -------------------------------------------------------------- refusals
REFUSED = {
    "DATA_PARALLEL": (dict(DATA_PARALLEL=2), NotImplementedError, "queue 1 item 4"),
    "REMAT": (dict(REMAT="frames"), ValueError, "unknown remat mode"),
    "GRAD_ACCUM_STEPS": (dict(GRAD_ACCUM_STEPS=3), ValueError, "must be a positive integer that "
                                                             "divides TRAIN.BATCH_SIZE"),
}


@pytest.mark.parametrize("entry", ["Trainer", "train_net"])
@pytest.mark.parametrize("flag", sorted(REFUSED))
def test_unported_flags_are_refused(files, tmp_path, flag, entry):
    fields, error, match = REFUSED[flag]
    cfg = _configure(Config(), files, tmp_path, **fields)
    with pytest.raises(error, match=re.escape(match)):
        if entry == "Trainer":
            Trainer(cfg, *files["states"], device="cpu")
        else:
            train_net(cfg, device="cpu")
    assert not os.path.exists(tmp_path / "checkpoints")


# ----------------------------------------------------- remat, accumulation
def _batch(B=2):
    c = _clip()
    return {k: torch.from_numpy(np.concatenate([v] * B)) for k, v in c.items()}


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def test_remat_modes_give_equal_losses_and_gradients(files):
    """"none", "encoders" and "step" through the port (flash read, plain
    version): the same loss and, per tensor, gradients within 1e-6 of the
    largest (the recompute runs the same float32 ops; only the order of
    gradient sums differs)."""
    trainer = Trainer(Config(), *files["states"], device="cpu")
    batch = _batch()
    out = {}
    for mode in ("none", "encoders", "step"):
        trainer.rmnet.zero_grad(set_to_none=True)
        loss = make_loss_fn(trainer.cfg, trainer.apply, trainer.tflownet, remat=mode)(batch)
        loss.backward()
        out[mode] = (loss.item(), _grads(trainer.rmnet))
    loss0, g0 = out["none"]
    gmax = max(g.abs().max().item() for g in g0.values())
    for mode in ("encoders", "step"):
        loss, g = out[mode]
        assert loss == pytest.approx(loss0, rel=1e-6)
        assert g.keys() == g0.keys()
        for name in g0:
            assert (g[name] - g0[name]).abs().max().item() <= 1e-6 * gmax, (mode, name)


def test_remat_step_recomputes_the_read(files, monkeypatch):
    """Under "step" the backward recomputes each frame: the read runs twice
    per frame, once under "encoders"."""
    from rmnet_tpu_torch.models import rmnet as rmnet_mod

    calls = []
    real = rmnet_mod.flash_memory_read
    monkeypatch.setattr(rmnet_mod, "flash_memory_read",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    trainer = Trainer(Config(), *files["states"], device="cpu")
    batch = _batch(1)
    T = batch["frames"].shape[1]
    for mode, want in (("encoders", T - 1), ("step", 2 * (T - 1))):
        calls.clear()
        make_loss_fn(trainer.cfg, trainer.apply, trainer.tflownet, remat=mode)(batch).backward()
        assert len(calls) == want, mode


def test_grad_accumulation_is_the_mean_of_micro_batch_gradients(files):
    """GRAD_ACCUM_STEPS = 2 at B = 2: one Adam step on the mean of the two
    single-clip gradients, and the mean of their losses."""
    cfg = Config()
    cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.GRAD_ACCUM_STEPS, cfg.TRAIN.REMAT = 2, 2, "none"
    batch = _batch()
    batch["frames"][1] = batch["frames"][1].flip(1)  # two different clips
    trainer = Trainer(cfg, *files["states"], device="cpu")
    loss = trainer.train_step(batch, lr=1e-3)

    ref = Trainer(dataclasses.replace(cfg, TRAIN=dataclasses.replace(cfg.TRAIN,
                                                                      GRAD_ACCUM_STEPS=1)),
                  *files["states"], device="cpu")
    loss_fn = make_loss_fn(ref.cfg, ref.apply, ref.tflownet)
    grads, losses = [], []
    for i in range(2):
        ref.rmnet.zero_grad(set_to_none=True)
        value = loss_fn({k: v[i:i + 1] for k, v in batch.items()})
        value.backward()
        losses.append(value.item())
        grads.append(_grads(ref.rmnet))
    assert loss == pytest.approx(np.mean(losses), rel=1e-6)
    for name, p in ref.rmnet.named_parameters():
        p.grad = (grads[0][name] + grads[1][name]) / 2 if name in grads[0] else None
    for group in ref.optimizer.param_groups:
        group["lr"] = 1e-3
    ref.optimizer.step()
    for (name, p), q in zip(trainer.rmnet.named_parameters(), ref.rmnet.parameters()):
        torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-6, atol=1e-7, msg=name)


# ----------------------------------------------------------- checkpoints
def test_full_state_checkpoint_round_trip(files, tmp_path):
    """The .pth with the Adam state loads with weights_only=True into a
    fresh optimizer, equal; the JAX package's load_weights_auto reads it."""
    cfg = Config()
    cfg.TRAIN.NETWORK = "TinyFlowNet"
    _, tfn = build_models(seed=3, device="cpu")
    opt = make_optimizer(cfg, tfn.parameters())
    step = make_train_step(cfg, None, tfn, opt)
    rs = np.random.RandomState(1)
    batch = {"frames": torch.from_numpy(rs.rand(1, 2, 64, 64, 3).astype(np.float32)),
             "flows": torch.from_numpy(rs.randn(1, 2, 64, 64, 2).astype(np.float32))}
    for _ in range(2):
        step(batch, 1e-3)
    rm_sd = files["states"][0]
    path = save_checkpoint(str(tmp_path), "ckpt-epoch-007", rm_sd, tfn.state_dict(),
                           epoch_index=7, best_metrics={"JF-Mean": 0.5},
                           optimizer=opt.state_dict())
    rm2, tfn2, extras = load_weights_auto(path)
    assert extras["epoch"] == 7 and extras["best_metrics"] == {"JF-Mean": 0.5}
    _, tfn_b = build_models(seed=4, device="cpu")
    tfn_b.load_state_dict(tfn2)
    opt2 = make_optimizer(cfg, tfn_b.parameters())
    opt2.load_state_dict(extras["optimizer"])
    assert adam_summary(opt2.state_dict()) == adam_summary(opt.state_dict())
    for p, q in zip(tfn.parameters(), tfn_b.parameters()):
        assert torch.equal(p, q)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][k], opt2.state[q][k])
    # the JAX package's .pth path ignores the optimizer
    rm_vars, _, jextras = jax_load_weights_auto(path, jax.tree_util.tree_map(
        np.zeros_like, files["rm_vars"]), jax.tree_util.tree_map(np.zeros_like, files["tfn_vars"]))
    assert jextras["epoch"] == 7
    back, _ = from_jax_variables(rm_vars, files["tfn_vars"])
    assert all(torch.equal(back[k], v) for k, v in rm_sd.items())


def _torchvision_format_sd():
    """A random ResNet-50 state dict with torchvision's names (layer1..3)
    and its extras (tests/test_backbone_init.py:18-33)."""
    from tests.torch_ref import TrunkT

    torch.manual_seed(0)
    rename = {"res2": "layer1", "res3": "layer2", "res4": "layer3"}
    sd = {}
    for k, v in TrunkT().state_dict().items():
        head = k.split(".", 1)[0]
        sd[k.replace(head, rename.get(head, head), 1)] = v
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(10, 2048), torch.zeros(10)
    return sd


def test_backbone_init_matches_jax(files, tmp_path):
    """Both trunks equal the JAX package's after its load_backbone_weights
    and from_jax_variables, heads and mask stems untouched, the same count."""
    path = str(tmp_path / "resnet50.pth")
    torch.save({"state_dict": _torchvision_format_sd()}, path)
    rmnet, _ = build_models(seed=0, device="cpu")
    n = load_backbone_weights(path, rmnet)
    rm_vars, n_j = jax_load_backbone_weights(path, files["rm_vars"])
    assert n == n_j > 200
    want, _ = from_jax_variables(rm_vars, files["tfn_vars"])
    got, init = rmnet.state_dict(), files["states"][0]
    trunk = [k for k in got if k.split(".")[1] in ("conv1", "bn1", "res2", "res3", "res4")
             and k.startswith("encoder_") and "num_batches" not in k]
    assert len(trunk) == n
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
        if k not in trunk and "num_batches" not in k:
            assert torch.equal(v, init[k]), k


def test_backbone_init_refusals(files, tmp_path):
    rmnet, _ = build_models(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="torchvision package"):
        load_backbone_weights("torchvision", rmnet)
    path = str(tmp_path / "other.pth")
    torch.save({"fc.weight": torch.zeros(2, 2)}, path)
    with pytest.raises(ValueError, match="no trunk weights"):
        load_backbone_weights(path, rmnet)


# ------------------------------------------------------------ skip rules
def _skip_cfg(files, out):
    cfg = _configure(Config(), files, out, CKPT_SAVE_THRESHOLD=2.0)  # ckpt-best only
    cfg.CONST.N_WORKERS = 0
    return cfg


@pytest.mark.parametrize("case", ["runtime_error", "accelerator_error", "all_skipped"])
def test_skip_rules(files, tmp_path, monkeypatch, case):
    """A batch whose step raises a plain RuntimeError is skipped and
    counted; a CUDA fault (torch.AcceleratorError) is raised; an epoch whose
    every batch was skipped raises."""
    calls = []
    real = Trainer.train_step

    def flaky(self, batch, lr=None):
        calls.append(1)
        if case == "accelerator_error":
            raise torch.AcceleratorError("CUDA error: an illegal memory access")
        if case == "all_skipped" or len(calls) == 1:
            raise RuntimeError("a bad batch")
        return real(self, batch, lr)

    monkeypatch.setattr(Trainer, "train_step", flaky)
    monkeypatch.chdir(tmp_path)
    stats = TrainStats()
    cfg = _skip_cfg(files, tmp_path)
    if case == "runtime_error":
        best = train_net(cfg, device="cpu", stats=stats)
        assert best is not None and stats.batches == 2 and stats.skipped == 1
        assert len(stats.batch_times) == 1 and len(stats.val_s) == 1
    elif case == "accelerator_error":
        with pytest.raises(torch.AcceleratorError):
            train_net(cfg, device="cpu", stats=stats)
        assert stats.skipped == 0
    else:
        with pytest.raises(RuntimeError, match="all 2 batches were skipped"):
            train_net(cfg, device="cpu", stats=stats)
        assert stats.skipped == 2


def test_non_finite_losses_are_counted(files, tmp_path, monkeypatch):
    monkeypatch.setattr(Trainer, "train_step", lambda self, batch, lr=None: float("nan"))
    monkeypatch.chdir(tmp_path)
    stats = TrainStats()
    with pytest.raises(RuntimeError, match="all 2 batches were skipped"):
        train_net(_skip_cfg(files, tmp_path), device="cpu", stats=stats)
    assert stats.non_finite == 2 and stats.skipped == 0


# -------------------------------------------------- SIGTERM and resume
def _runner(cfg_file, out, *args):
    return subprocess.Popen(
        [sys.executable, "-m", "rmnet_tpu_torch.runner", "--device", "cpu", "--cfg", cfg_file,
         "--exp", "sig", *args], cwd=out, env={**os.environ, "PYTHONPATH": ROOT},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_sigterm_checkpoints_and_resume_continues(files, tmp_path):
    """The CLI trains on the CPU; SIGTERM after its first batch makes it
    exit 0 with ckpt-interrupt.pth holding the interrupted epoch - 1 and the
    Adam state; --weights on that file starts at the interrupted epoch with
    that Adam state and exits 0."""
    tree_index, img, ann, flo = files["tree"]
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text(
        "def configure(cfg):\n"
        f"    cfg.DATASETS.DAVIS.INDEXING_FILE_PATH = {tree_index!r}\n"
        f"    cfg.DATASETS.DAVIS.IMG_FILE_PATH = {img + '/%s/%05d.jpg'!r}\n"
        f"    cfg.DATASETS.DAVIS.ANNOTATION_FILE_PATH = {ann + '/%s/%05d.png'!r}\n"
        f"    cfg.DATASETS.DAVIS.OPTICAL_FLOW_FILE_PATH = {flo + '/%s/%05d.flo'!r}\n"
        "    cfg.DATASET.TRAIN_DATASET = ['DAVISx4']\n"
        f"    cfg.TRAIN.AUGMENTATION.RESIZE_SIZE = {CROP}\n"
        f"    cfg.TRAIN.AUGMENTATION.CROP_HSIZE = cfg.TRAIN.AUGMENTATION.CROP_WSIZE = {CROP}\n"
        "    cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.N_MAX_FRAMES, cfg.TRAIN.N_MAX_OBJECTS = 2, 2, 2\n"
        "    cfg.TRAIN.N_EPOCHS, cfg.TRAIN.REMAT, cfg.TRAIN.CKPT_SAVE_THRESHOLD = 1, 'none', 2.0\n"
        "    cfg.TEST.N_MAX_OBJECTS, cfg.TEST.TESTING_VIDEOS_INDEXES = 2, (0,)\n"
        "    cfg.CONST.N_WORKERS = 2\n"
        f"    cfg.DIR.OUTPUT_DIR = {str(tmp_path / 'out')!r}\n")
    ckpt_dir = tmp_path / "out" / "checkpoints" / "sig"
    proc = _runner(str(cfg_file), tmp_path)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if "[Batch 1/" in line:
            proc.send_signal(signal.SIGTERM)
            break
    out, _ = proc.communicate(timeout=120)
    log = "".join(lines) + out
    assert proc.returncode == 0, log[-3000:]
    stopped = int(re.search(r"Stopped in epoch (\d+)", log).group(1))
    ckpt = torch.load(ckpt_dir / "ckpt-interrupt.pth", weights_only=True)
    assert ckpt["epoch_index"] == stopped - 1
    saved = adam_summary(ckpt["optimizer"])

    proc = _runner(str(cfg_file), tmp_path, "--weights", str(ckpt_dir / "ckpt-interrupt.pth"))
    out, _ = proc.communicate(timeout=180)
    assert proc.returncode == 0, out[-3000:]
    assert f"Current epoch = #{stopped - 1}" in out and saved in out
    first = re.search(r"\[Epoch (\d+)/1\]\[Batch 1/", out)
    assert int(first.group(1)) == stopped == 1
    best = torch.load(ckpt_dir / "ckpt-best.pth", weights_only=True)
    steps = {int(s["step"]) for s in best["optimizer"]["state"].values()}
    # the interrupted run's steps, then the 4 batches of the repeated epoch
    trained_before = int(saved.split("steps [")[1].split("]")[0])
    assert best["epoch_index"] == 1 and steps == {trained_before + 4}
