"""Operations and bytes the work needs, counted from its inputs and shapes:
the table of peaks, the memory read's least time (the repository's smoke
test's ``read_bound`` / ``read_bwd_bound`` arithmetic) and the model's
FLOPs, counted once from the reference's layer shapes.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
from torch import nn

from vosbench.reference import rmnet_ref

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,
              # float32 products on the tensor cores: the published TF32 rate,
              # so that no implementation of a float32 product reads over 100%
              "float32": 495e12}
PEAK_BYTES = 3.35e12  # HBM3 bytes per second
GRID = 16             # full-resolution pixels per cell of the /16 grid


def peak_flops(dtype: torch.dtype) -> float:
    return PEAK_FLOPS[str(dtype).replace("torch.", "")]


def inbox_positions(m_key, q_key, slot_valid, bboxes) -> torch.Tensor:
    """In-box valid memory positions of a read, a 0-d int64 tensor on the
    inputs' device: the positions whose keys and values can be nonzero, the
    work a read needs. A /16 cell (i, j) lies in a slot's box (x_min, x_max,
    y_min, y_max, padded full-resolution pixels) when (16 i, 16 j) does."""
    h, w = m_key.shape[2:4]
    ys = torch.arange(h, device=q_key.device) * GRID
    xs = torch.arange(w, device=q_key.device) * GRID
    b = bboxes[:, :, :, None, None]
    cell = ((ys[:, None] >= b[:, :, 2]) & (ys[:, None] <= b[:, :, 3])
            & (xs[None] >= b[:, :, 0]) & (xs[None] <= b[:, :, 1]))
    return (cell & slot_valid[:, :, None, None]).sum()


def read_terms(m_key, m_val, q_key, inbox):
    """(forward flops, forward bytes, backward flops, backward bytes) of a
    read with ``inbox`` in-box valid positions (a number or a tensor): per
    such position 2 Q (Ck + Cv) operations forward (S = qK, O = PV) and 2 Q
    (3 Ck + 2 Cv) backward (S, dP = dO V, dV, dK, dQ); each input byte read
    and each output byte written once (K, V at those positions, q, out and
    lse forward; K, V, dK, dV, q, dO, dQ, lse and D backward)."""
    N = m_key.shape[0]
    Ck, Cv = m_key.shape[-1], m_val.shape[-1]
    Q = q_key.shape[1] * q_key.shape[2]
    es = q_key.element_size()
    fwd_flops = 2.0 * Q * inbox * (Ck + Cv)
    fwd_bytes = (inbox * (Ck + Cv) + N * Q * (Ck + Cv)) * es + N * Q * 4
    bwd_flops = 2.0 * Q * inbox * (3 * Ck + 2 * Cv)
    bwd_bytes = (2 * inbox * (Ck + Cv) + N * Q * (2 * Ck + Cv)) * es + 2 * N * Q * 4
    return fwd_flops, fwd_bytes, bwd_flops, bwd_bytes


def least_seconds(flops, nbytes, dtype):
    """The larger of operations over the peak rate and bytes over the peak
    bandwidth (tensors or numbers)."""
    op_s, byte_s = flops / peak_flops(dtype), nbytes / PEAK_BYTES
    if torch.is_tensor(op_s):
        return torch.maximum(op_s, byte_s)
    return max(op_s, byte_s)


class ReadWork:
    """Counts the memory read's least time, forward and backward, on the
    device: installed in place of the module-level ``flash_memory_read`` of
    the program's model module before anything is captured, it adds each
    call's terms (torch ops on a device accumulator, so that a CUDA graph
    replays them) and then makes the call unchanged. Counted from the
    inputs, never from what the kernel executes."""

    FWD_S, BWD_S, CALLS = 0, 1, 2

    def __init__(self, module, device):
        self.module = module
        self.real = module.flash_memory_read
        self.acc = torch.zeros(3, dtype=torch.float64, device=device)

    def __enter__(self):
        def counted(m_key, m_val, q_key, slot_valid, bboxes=None):
            inbox = inbox_positions(m_key, q_key, slot_valid, bboxes).double()
            ff, fb, bf, bb = read_terms(m_key, m_val, q_key, inbox)
            self.acc.add_(torch.stack([least_seconds(ff, fb, q_key.dtype),
                                       least_seconds(bf, bb, q_key.dtype),
                                       torch.ones_like(inbox)]))
            return self.real(m_key, m_val, q_key, slot_valid, bboxes)

        self.module.flash_memory_read = counted
        return self

    def __exit__(self, *exc):
        self.module.flash_memory_read = self.real

    def zero(self) -> None:
        self.acc.zero_()

    def read(self) -> Dict[str, float]:
        fwd, bwd, calls = self.acc.tolist()
        return dict(fwd_bound_s=fwd, bwd_bound_s=bwd, calls=calls)


# ----------------------------------------------------------- model FLOPs
def _conv_flops(module: nn.Module, *inputs) -> Dict[str, float]:
    """FLOPs of every convolution of ``module`` called on meta tensors of
    these shapes, by the conv's name: 2 Cout (Cin / groups) kh kw per output
    pixel (a transposed conv: per input pixel, Cin Cout kh kw)."""
    out: Dict[str, float] = {}
    hooks = []
    for name, mod in module.named_modules():
        if isinstance(mod, nn.Conv2d):
            def hook(m, args, y, name=name):
                k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                out[name] = out.get(name, 0.0) + 2.0 * y.numel() * k
        elif isinstance(mod, nn.ConvTranspose2d):
            def hook(m, args, y, name=name):
                x = args[0]
                out[name] = out.get(name, 0.0) + 2.0 * x.numel() * m.weight[0].numel()
        else:
            continue
        hooks.append(mod.register_forward_hook(hook))
    try:
        with torch.no_grad():
            module(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return out


def _meta(*shape):
    return torch.zeros(shape, device="meta")


def frame_flops(H: int, W: int, n_obj: int, with_flow: bool) -> Dict[str, float]:
    """FLOPs of the convolutions of one frame of the reference loop for one
    stream with ``n_obj`` objects at H x W: the flow pair (with_flow),
    memorize (memory encoder and key/value heads per object), the query
    encoder and its heads once, the decoder's frame-only skip branches once
    and its object branches per object. The reference computes the skip
    branches per object; they depend on the frame alone, so the model's
    work counts them once."""
    rm, tfn = rmnet_ref.build()
    Hp, Wp = H + (-H) % 16, W + (-W) % 16
    h, w = Hp // 16, Wp // 16
    f = {}
    if with_flow:
        f["flow"] = sum(_conv_flops(_PairModule(tfn), _meta(1, 3, H, W), _meta(1, 3, H, W))
                        .values())
    mem = sum(_conv_flops(rm.encoder_memory, _meta(1, 3, Hp, Wp), _meta(1, Hp, Wp),
                          _meta(1, Hp, Wp)).values())
    kv = sum(_conv_flops(rm.kv_memory, _meta(1, 1024, h, w)).values())
    f["memorize"] = n_obj * (mem + kv)
    f["query"] = sum(_conv_flops(rm.encoder_query, _meta(1, 3, Hp, Wp)).values()) + kv
    dec = _conv_flops(rm.decoder, _meta(1, 1024, h, w), _meta(1, 512, 2 * h, 2 * w),
                      _meta(1, 256, 4 * h, 4 * w))
    skip = sum(v for k, v in dec.items() if ".convFS" in k or ".ResFS" in k)
    f["decoder"] = skip + n_obj * (sum(dec.values()) - skip)
    return f


class _PairModule(nn.Module):
    def __init__(self, tfn):
        super().__init__()
        self.tfn = tfn

    def forward(self, a, b):
        return self.tfn.pair(a, b)


def read_flops(H: int, W: int, n_obj: int, slots: int, Ck: int = 128, Cv: int = 512) -> float:
    """FLOPs of the reference's dense memory read of one frame: each object's
    query against every position of ``slots`` valid bank slots."""
    Q = math.ceil(H / 16) * math.ceil(W / 16)
    return 2.0 * n_obj * Q * (slots * Q) * (Ck + Cv)


def commits(T: int, memorize_every: int, appear: Sequence[int]):
    """Which frames the bank commits: every ``memorize_every``-th and each
    frame before which an object first appears (reference
    models/rmnet.py:404-408)."""
    new_at = {a for a in appear if 0 < a < T}
    return [t % memorize_every == 0 or t in new_at for t in range(T)]


def video_flops(T: int, H: int, W: int, appear: Sequence[int], memorize_every: int,
                with_flow: bool = True) -> float:
    """Model FLOPs of one video of the reference loop: frames 1..T-1, every
    object of the clip encoded from the start (the reference sizes the
    object axis by the clip's largest count), the read over the slots
    committed before frame t-1 plus frame t-1's own."""
    n_obj = len(appear)
    per_frame = sum(frame_flops(H, W, n_obj, with_flow).values())
    commit = commits(T, memorize_every, appear)
    total = 0.0
    for t in range(1, T):
        total += per_frame + read_flops(H, W, n_obj, sum(commit[:t - 1]) + 1)
    return total


def train_step_flops(B: int, T: int, H: int, W: int, n_obj: int, memorize_every: int) -> float:
    """Model FLOPs of one training step: the forward of B clips of T frames
    with given flows (video_flops without the flow net, the last object
    appearing at t=1), and a backward of twice the forward."""
    appear = [0] * (n_obj - 1) + [1]
    return 3.0 * B * video_flops(T, H, W, appear, memorize_every, with_flow=False)
