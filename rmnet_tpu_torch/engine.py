"""Streaming VOS inference engine on one GPU (counterpart of
rmnet_tpu/core/engine.py).

Weights stay on the device for the engine's lifetime. A video runs in chunks
of ``chunk`` frames: ``RMNetApply.chunk_forward`` takes the chunk's steps
(TinyFlowNet flow from the carried previous frame, memorize, the ring write
at each stream's cursor, the block-sparse flash read, segment) with every
flag on the device, so no value comes back to the host inside a chunk. On
the card each chunk is one replay of a CUDA graph, captured once per
geometry: the counterpart of the JAX engine's one jitted scan per chunk. On
the CPU the same function runs eagerly. Inputs go up per chunk through
pinned buffers; labels (or probabilities) come down through pinned buffers
while the next chunk runs. N videos run as the model's batch, each with its
own cursor, flags and length.
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from rmnet_tpu_torch.models.rmnet import RMNet, RMNetApply, VOSState
from rmnet_tpu_torch.models.tiny_flownet import TinyFlowNet
from rmnet_tpu_torch.models.weights import build_models  # noqa: F401  (re-export)
from rmnet_tpu_torch.ops.flash_attention import LIBRARY, flash_memory_read
from rmnet_tpu_torch.ops.resize import resize_bilinear, resize_nearest, scale_hw


def _on_device(module_cls, state: Mapping[str, torch.Tensor], device, dtype):
    with torch.device("meta"):
        net = module_cls()
    net = net.to_empty(device=device)
    net.load_state_dict(state)
    return net.to(dtype).eval().requires_grad_(False)


# geometries whose state and chunk programs (bank, static buffers, pinned
# host twins, CUDA graphs) an engine keeps: a video under two-scale TTA
# alternates two; a third geometry evicts the least recently used one
GEOMETRIES_KEPT = 2


def _one_hot(labels: torch.Tensor, K: int) -> torch.Tensor:
    """uint8 label maps (..., H, W) -> float32 one-hot (..., K, H, W); a label
    outside [0, K), such as the ignore label 255, gives an all-zero row, as
    ``jax.nn.one_hot`` does (``F.one_hot`` would raise on it)."""
    ks = torch.arange(K, device=labels.device)[:, None, None]
    return (labels.unsqueeze(-3).long() == ks).to(torch.float32)


class _ChunkProgram:
    """One chunk size of one geometry: the static input tensors, the output
    and, on the card, the CUDA graph that reads the one and writes the
    other, with pinned host twins of both for the copies."""

    def __init__(self, fn, inputs: Dict[str, torch.Tensor], pool):
        self.fn, self.inputs = fn, inputs
        self.graph = None
        if next(iter(inputs.values())).device.type != "cuda":
            self.staged = inputs  # the host fills the inputs themselves
            return
        self.staged = {k: torch.zeros(v.shape, dtype=v.dtype, pin_memory=True)
                       for k, v in inputs.items()}
        self.uploaded = torch.cuda.Event()  # the last copy out of ``staged``
        # warm up on a side stream (cuDNN plans, the allocator), then capture
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = flash_memory_read.captured
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = fn(inputs)
        self.flash_calls = flash_memory_read.captured - before
        self.out_host = [torch.empty(self.out.shape, dtype=self.out.dtype, pin_memory=True)
                         for _ in range(2)]
        self.turn = 0

    def staging(self) -> Dict[str, np.ndarray]:
        """The host buffers to fill with the next chunk's inputs, once the
        card has finished copying the last chunk's out of them."""
        if self.graph is not None:
            self.uploaded.synchronize()
        return {k: v.numpy() for k, v in self.staged.items()}

    def upload(self, gt_steps=None) -> None:
        """Copy the staged inputs to the card; of "gt", only ``gt_steps``
        when given."""
        if self.graph is None:
            return
        for name, dst in self.inputs.items():
            src = self.staged[name]
            if name == "gt" and gt_steps is not None:
                for s in gt_steps:
                    dst[s].copy_(src[s], non_blocking=True)
            else:
                dst.copy_(src, non_blocking=True)
        self.uploaded.record()

    def run(self) -> torch.Tensor:
        if self.graph is None:
            return self.fn(self.inputs)
        self.graph.replay()
        flash_memory_read.replayed += self.flash_calls
        return self.out

    def download(self, out: torch.Tensor):
        """Start the copy of ``out`` (this program's result) to the host ->
        (host tensor, event that marks its arrival, or None)."""
        if self.graph is None:
            return out, None
        buf = self.out_host[self.turn]
        self.turn ^= 1
        buf.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return buf, done


class InferenceEngine:
    """Holds RMNet + TinyFlowNet on one device and runs videos."""

    def __init__(
        self,
        cfg,
        rmnet_state: Mapping[str, torch.Tensor],
        tflownet_state: Mapping[str, torch.Tensor],
        memorize_every: Optional[int] = None,
        capacity: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        chunk: int = 8,
        use_flash_attention: Optional[bool] = None,
        device=None,
        apply_overrides: Optional[Dict[str, Any]] = None,
    ):
        """``device=None`` means the card; there is no fallback to the CPU.
        ``use_flash_attention=None`` means the block-sparse flash read."""
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("InferenceEngine: no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        self.cfg = cfg
        self.dtype = dtype
        self.chunk = chunk
        self.rmnet = _on_device(RMNet, rmnet_state, self.device, dtype)
        self.tflownet = _on_device(TinyFlowNet, tflownet_state, self.device, dtype)
        self.memorize_every = memorize_every or cfg.TEST.MEMORIZE_EVERY
        # capacity 0 = AUTO: sized per video so the bank never evicts (the
        # reference's bank grows without bound); a fixed capacity evicts the
        # oldest slot on long videos, warned in _capacity_for
        self.capacity = capacity if capacity is not None else cfg.TEST.MEMORY_CAPACITY
        self.use_flash_attention = True if use_flash_attention is None else use_flash_attention
        self.apply = RMNetApply(
            self.rmnet,
            memorize_every=self.memorize_every,
            use_flash_attention=self.use_flash_attention,
            **(apply_overrides or {}),
        )
        self._mean = torch.tensor(cfg.CONST.DATASET_MEAN, dtype=torch.float32,
                                  device=self.device)
        self._std = torch.tensor(cfg.CONST.DATASET_STD, dtype=torch.float32,
                                 device=self.device)
        # (N, H, W, K, capacity) -> (state, obj_valid, chunk programs): one
        # video batch's device state, shared by the chunk programs of that
        # geometry (a video's tail chunks continue its full chunks' state);
        # the GEOMETRIES_KEPT most recently used, oldest first
        self._geometries: Dict[Tuple, Tuple[VOSState, torch.Tensor, Dict]] = {}
        # all graphs of the engine allocate from one memory pool; they run
        # one at a time on one stream
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self.replays = 0  # chunk programs run, on the card graph replays

    def update_weights(self, rmnet_state, tflownet_state) -> None:
        """Swap in new checkpoint weights, in place on the device: captured
        graphs read the same parameter storage, so their next replay runs
        the new weights."""
        self.rmnet.load_state_dict(rmnet_state)
        self.tflownet.load_state_dict(tflownet_state)

    def _capacity_for(self, T: int, commit: np.ndarray) -> int:
        """Per-video bank capacity: the commit count bucketed to a multiple
        of 8, or of 32 with the flash read (padded slots are invalid and the
        kernel skips their tiles); a fixed capacity is honoured but warned
        about when it would evict."""
        needed = int(np.sum(commit[: max(T - 1, 1)]))
        if self.capacity:
            if needed > self.capacity:
                logging.warning(
                    "memory bank capacity %d < %d commits for a %d-frame video: "
                    "the %d oldest committed memories (including frame 0's "
                    "ground-truth memory) will be evicted; the reference never "
                    "evicts. Set TEST.MEMORY_CAPACITY=0 for auto sizing.",
                    self.capacity, needed, T, needed - self.capacity,
                )
            return self.capacity
        bucket = 32 if self.use_flash_attention else 8
        return max(bucket, -(-needed // bucket) * bucket)

    def _video_flags(self, n_objects: np.ndarray, T: int):
        any_new = np.zeros((T,), bool)
        any_new[1:] = n_objects[1:] != n_objects[:-1]
        in_to_mem = np.array([(t % self.memorize_every) == 0 for t in range(T)])
        return any_new, in_to_mem | any_new

    def _chunk_plan(self, n_steps: int):
        """Chunk sizes for a video: full chunks, then a tapered tail of
        chunk/4-sized chunks (the last chunk's download overlaps nothing);
        a short video is one padded chunk (rmnet_tpu/core/engine.py:286-306)."""
        C = self.chunk
        small = max(1, C // 4)
        plan = []
        left = n_steps
        while left > C:
            plan.append(C)
            left -= C
        if left == n_steps and left <= C:
            return [C]
        while left > 0:
            plan.append(small)
            left -= small
        return plan

    def _normalize(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """uint8 RGB (..., 3) -> ImageNet-normalized float32."""
        return (frames_u8.to(torch.float32) / 255.0 - self._mean) / self._std

    def _chunk_fn(self, state, obj_valid, raw: bool, return_probs: bool, inp):
        """One chunk on the static inputs ``inp``: uint8 frames (C, N, H, W, 3)
        and label maps (C, N, H, W) with ``raw``, else float32 frames and
        one-hot masks (C, N, K, H, W); flags (C, N) -> uint8 labels
        (C, N, H, W), or float32 probabilities (C, N, K, H, W)."""
        frames, gt = inp["frames"], inp["gt"]
        if raw:
            frames, gt = self._normalize(frames), _one_hot(gt, obj_valid.shape[1])
        flows = inp.get("flows")
        est = self.apply.chunk_forward(
            self.tflownet.pair_forward, state, frames.permute(0, 1, 4, 2, 3).contiguous(),
            gt, inp["any_new"], inp["commit"], inp["valid"], obj_valid,
            flows=None if flows is None else flows.permute(0, 1, 4, 2, 3).contiguous())
        return est if return_probs else est.argmax(dim=2).to(torch.uint8)

    def _geometry(self, geometry, frame0, masks0):
        """The state, object validity and chunk programs of ``geometry``,
        made at its first use; marks it the most recently used and evicts
        the least recently used past GEOMETRIES_KEPT."""
        entry = self._geometries.pop(geometry, None)
        if entry is None:
            while len(self._geometries) >= GEOMETRIES_KEPT:
                del self._geometries[next(iter(self._geometries))]
            N, _, _, K, capacity = geometry
            entry = (self.apply.init_state(frame0, masks0, capacity, dtype=self.dtype),
                     torch.zeros((N, K), dtype=torch.bool, device=self.device), {})
        self._geometries[geometry] = entry
        return entry

    def _program(self, geometry, C: int, with_flows: bool, return_probs: bool,
                 raw: bool) -> _ChunkProgram:
        N, H, W, K, capacity = geometry
        state, obj_valid, programs = self._geometries[geometry]
        key = (C, with_flows, return_probs, raw)  # the engine's dtype is fixed
        if key not in programs:
            if self.device.type == "cuda":
                LIBRARY.load()  # nvcc at first use, never inside a capture
            z = functools.partial(torch.zeros, device=self.device)
            inputs = {
                "frames": z((C, N, H, W, 3), dtype=torch.uint8 if raw else torch.float32),
                "gt": z((C, N, H, W), dtype=torch.uint8) if raw else z((C, N, K, H, W)),
                "any_new": z((C, N), dtype=torch.bool),
                "commit": z((C, N), dtype=torch.bool),
                "valid": z((C, N), dtype=torch.bool),
            }
            if with_flows:
                inputs["flows"] = z((C, N, H, W, 2))
            fn = functools.partial(self._chunk_fn, state, obj_valid, raw, return_probs)
            programs[key] = _ChunkProgram(fn, inputs, self._pool)
        return programs[key]

    @torch.inference_mode()
    def _run(self, frames, masks, n_objects, flows, return_probs: bool,
             lengths=None, n_slots: Optional[int] = None, accumulate_into=None):
        """N videos through the chunk programs.

        frames (N, T, H, W, 3) normalized float32; masks (N, T, K, H, W)
        one-hot (frame 0 required). With ``n_slots`` (raw input): frames
        uint8 RGB and masks (N, T, H, W) uint8 label maps (255 = ignore),
        one-hot with n_slots on the device. n_objects (N, T); flows (N, T,
        H, W, 2) or None (TinyFlowNet in the chunk); lengths (N,) true
        lengths, steps past which leave a stream's state as it was. Returns
        (N, T, H, W) uint8 labels or (N, T, K, H, W) float32 probabilities;
        with ``accumulate_into=(acc, flip)``, adds the probabilities of
        frames 1.. to the device tensor acc (rows, K, H', W') instead,
        un-flipped and resized to (H', W').
        """
        dev = self.device
        raw = n_slots is not None
        N, T, H, W = frames.shape[:4]
        K = n_slots if raw else masks.shape[2]
        lengths = np.full((N,), T) if lengths is None else np.asarray(lengths)
        n_objects = np.asarray(n_objects)
        plan = self._chunk_plan(T - 1)
        rows = 1 + sum(plan)

        # per-stream flags, time-major, False past each stream's length and
        # on the padded tail of the last chunk
        any_new = np.zeros((rows, N), bool)
        commit = np.zeros((rows, N), bool)
        for i in range(N):
            a, c = self._video_flags(n_objects[i], T)
            any_new[:lengths[i], i] = a[:lengths[i]]
            commit[:lengths[i], i] = c[:lengths[i]]
        valid = np.arange(rows)[:, None] < lengths[None]
        capacity = max(self._capacity_for(int(lengths[i]), commit[:, i]) for i in range(N))
        n_max = n_objects.max(axis=1)
        obj_valid = (np.arange(K)[None] >= 1) & (np.arange(K)[None] <= n_max[:, None])

        frame0 = np.ascontiguousarray(frames[:, 0], None if raw else np.float32)
        frame0 = torch.from_numpy(frame0).to(dev)
        if raw:
            labels0 = torch.from_numpy(np.ascontiguousarray(masks[:, 0])).to(dev)
            frame0, masks0 = self._normalize(frame0), _one_hot(labels0, K)
        else:
            masks0 = torch.from_numpy(np.asarray(masks[:, 0], np.float32)).to(dev)
        frame0 = frame0.permute(0, 3, 1, 2)
        geometry = (N, H, W, K, capacity)
        state, obj_valid_d, _ = self._geometry(geometry, frame0, masks0)
        # capture first: a program's warm-up runs on the state
        programs = {C: self._program(geometry, C, flows is not None, return_probs, raw)
                    for C in dict.fromkeys(plan)}
        state.reset_(frame0, masks0)
        obj_valid_d.copy_(torch.from_numpy(obj_valid))

        if accumulate_into is not None:
            acc, flip = accumulate_into
        elif return_probs:
            out = np.zeros((T, N, K, H, W), np.float32)
            out[0] = masks[:, 0]
        elif raw:
            out = np.zeros((T, N, H, W), np.uint8)
            out[0] = np.where(masks[:, 0] == 255, 0, masks[:, 0])
        else:
            out = np.zeros((T, N, H, W), np.uint8)
            out[0] = np.argmax(masks[:, 0], axis=1)

        def materialize(pending):
            buf, done, p_t, p_end = pending
            if done is not None:
                done.synchronize()
            out[p_t:p_end] = buf.numpy()[: p_end - p_t]

        pending = None
        t = 1
        for size in plan:
            end = min(t + size, T)
            prog = programs[size]
            x = prog.staging()
            for s in range(size):  # padded steps repeat the last frame
                x["frames"][s] = frames[:, min(t + s, T - 1)]
                if flows is not None:
                    x["flows"][s] = flows[:, min(t + s, T - 1)]
            x["any_new"][:] = any_new[t:t + size]
            x["commit"][:] = commit[t - 1:t - 1 + size]
            x["valid"][:] = valid[t:t + size]
            if raw:
                gt_steps = None
                for s in range(size):
                    x["gt"][s] = masks[:, min(t + s, T - 1)]
            else:
                # the masks are read only where any_new: refresh those steps
                gt_steps = np.flatnonzero(any_new[t:t + size].any(axis=1))
                for s in gt_steps:
                    x["gt"][s] = masks[:, t + s]
            prog.upload(gt_steps)
            res = prog.run()
            self.replays += 1
            if accumulate_into is not None:
                est = res[:, 0]  # (size, K, h, w) float32
                if flip:
                    est = est.flip(-1)
                if est.shape[-2:] != acc.shape[-2:]:
                    est = resize_bilinear(est, acc.shape[-2:], spatial_axes=(-2, -1))
                acc[t:t + size] += est
            else:
                # the previous chunk comes down while this one runs
                if pending is not None:
                    materialize(pending)
                pending = (*prog.download(res), t, end)
            t = end
        if pending is not None:
            materialize(pending)
        return None if accumulate_into is not None else np.moveaxis(out, 0, 1)

    # ------------------------------------------------------------- serving
    def run_video_labels(self, frames, masks, n_objects, flows=None) -> np.ndarray:
        """frames (T, H, W, 3) normalized float32, masks (T, K, H, W) one-hot
        (frame 0 required), n_objects (T,) -> (T, H, W) uint8 labels.
        ``flows=None`` computes TinyFlowNet flows inside the chunk."""
        return self._run(frames[None], masks[None], np.asarray(n_objects)[None],
                         None if flows is None else flows[None], return_probs=False)[0]

    def run_video(self, frames, masks, n_objects, flows=None) -> np.ndarray:
        """Same inputs -> (T, K, H, W) float32 probabilities."""
        return self._run(frames[None], masks[None], np.asarray(n_objects)[None],
                         None if flows is None else flows[None], return_probs=True)[0]

    def run_videos_labels(self, frames, masks, n_objects, flows=None) -> np.ndarray:
        """Lockstep multi-stream serving: N equal-length videos as the
        model's batch. frames (N, T, H, W, 3), masks (N, T, K, H, W),
        n_objects (N, T), flows (N, T, H, W, 2) or None -> (N, T, H, W)
        uint8 labels. Videos of different lengths: :meth:`run_video_batch`."""
        return self._run(frames, masks, n_objects, flows, return_probs=False)

    def run_videos(self, frames, masks, n_objects, flows=None) -> np.ndarray:
        """Multi-stream probability path: (N, T, K, H, W) float32."""
        return self._run(frames, masks, n_objects, flows, return_probs=True)

    def run_video_batch(self, videos, return_probs: bool = False):
        """Ragged multi-stream serving: videos of different lengths, object
        counts and commit schedules as one batch. ``videos``: a sequence of
        (frames, masks, n_objects) or (frames, masks, n_objects, flows).
        Returns a list of per-video outputs at each video's true length
        ((T_i, H, W) uint8 labels, or (T_i, K_max, H, W) float32
        probabilities). Shorter videos are padded to the longest and frozen
        past their last frame; masks are zero-padded to the largest K."""
        vids = [tuple(v) for v in videos]
        if not vids:
            return []
        has_flows = len(vids[0]) >= 4 and vids[0][3] is not None
        if any((len(v) >= 4 and v[3] is not None) != has_flows for v in vids):
            raise ValueError(
                "run_video_batch: either every video carries precomputed flows or "
                "none does (TinyFlowNet in the chunk and given flows are different "
                "programs)")
        H, W = vids[0][0].shape[1:3]
        if any(v[0].shape[1:3] != (H, W) for v in vids):
            raise ValueError("run_video_batch: all videos must share the frame size; "
                             "group them by resolution")
        lengths = np.array([v[0].shape[0] for v in vids])
        T = int(lengths.max())
        K = max(v[1].shape[1] for v in vids)

        def pad_t(a, T_i):
            return np.concatenate([a, np.repeat(a[-1:], T - T_i, 0)], 0) if T_i < T else a

        frames = np.stack([pad_t(v[0], n) for v, n in zip(vids, lengths)])
        masks = np.stack([
            pad_t(np.pad(v[1], ((0, 0), (0, K - v[1].shape[1]), (0, 0), (0, 0))), n)
            for v, n in zip(vids, lengths)])
        n_objects = np.stack([pad_t(np.asarray(v[2]), n) for v, n in zip(vids, lengths)])
        flows = None
        if has_flows:
            flows = np.stack([pad_t(v[3], n) for v, n in zip(vids, lengths)])
        out = self._run(frames, masks, n_objects, flows, return_probs=return_probs,
                        lengths=lengths)
        return [out[i, :n] for i, n in enumerate(lengths)]

    def run_video_raw(self, frames_u8, gt_labels, n_objects, n_slots=None) -> np.ndarray:
        """Raw-input path: frames_u8 (T, H, W, 3) uint8 RGB, gt_labels (T, H, W)
        uint8 label maps (255 = ignore), n_objects (T,) -> (T, H, W) uint8
        labels. Normalization and the one-hot happen on the device, so a
        chunk's upload is a quarter of the float32 path's frames."""
        K = n_slots or int(np.max(n_objects)) + 1
        return self._run(frames_u8[None], gt_labels[None], np.asarray(n_objects)[None],
                         None, return_probs=False, n_slots=K)[0]

    # ---------------------------------------------------------------- flows
    @torch.inference_mode()
    def compute_flows(self, frames, chunk: Optional[int] = None) -> np.ndarray:
        """TinyFlowNet backward flows (T, H, W, 2) float32 for a (T, H, W, 3)
        video, a host array or a tensor on the engine's device (uploaded
        once), ``chunk`` pairs per batch (the last batch padded by repeating
        its last pair); flow[0] = 0."""
        chunk = chunk or self.chunk
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(np.ascontiguousarray(frames, np.float32))
        x = frames.to(self.device, torch.float32).permute(0, 3, 1, 2)
        T, _, H, W = x.shape
        flows = np.zeros((T, H, W, 2), np.float32)
        for start in range(0, T - 1, chunk):
            end = min(start + chunk, T - 1)
            idx = torch.arange(start, start + chunk, device=self.device).clamp(max=end - 1)
            out = self.tflownet.pair_forward(x[idx + 1], x[idx])
            flows[1 + start:1 + end] = out.permute(0, 2, 3, 1)[: end - start].float().cpu().numpy()
        return flows

    # -------------------------------------------------- multi-scale / flip
    def multi_scale_inference(self, frames, masks, n_objects):
        """Test-time augmentation: ``TEST.FRAME_SCALES`` and, with
        ``TEST.FLIP_LR``, the left-right flip of each, averaged (reference
        utils/helpers.py:44-78). Returns (flows at the 1.0-scale grid, or
        None without augmentation; probabilities (T, K, H, W)). Each pass's
        probabilities are un-flipped, resized to the 1.0-scale grid and
        summed on the device; the average comes down once."""
        cfg = self.cfg
        T, K, H, W = masks.shape
        if tuple(cfg.TEST.FRAME_SCALES) == (1.0,) and not cfg.TEST.FLIP_LR:
            return None, self.run_video(frames, masks, n_objects)
        n_objects = np.asarray(n_objects)
        with torch.inference_mode():
            # rows past T take the padded tail of the last chunk
            acc = torch.zeros((1 + sum(self._chunk_plan(T - 1)), K, H, W),
                              dtype=torch.float32, device=self.device)
            n_passes, flows_out = 0, None
            for fs in cfg.TEST.FRAME_SCALES:
                if fs == 1.0:
                    f_s, m_s = frames, masks
                    fl_s = self.compute_flows(frames)
                else:
                    # resized on the device, where compute_flows reads them;
                    # the chunks upload the host copy
                    hw = scale_hw(H, W, fs)
                    f_dev = resize_bilinear(torch.from_numpy(frames).to(self.device), hw)
                    fl_s = self.compute_flows(f_dev)
                    f_s = f_dev.cpu().numpy()
                    m_s = resize_nearest(torch.from_numpy(np.asarray(masks, np.float32)), hw,
                                         spatial_axes=(-2, -1)).numpy().astype(masks.dtype)
                passes = [(f_s, m_s, fl_s, False)]
                if cfg.TEST.FLIP_LR:
                    fl_f = fl_s[:, :, ::-1].copy()
                    fl_f[..., 0] = -fl_f[..., 0]
                    passes.append((f_s[:, :, ::-1].copy(), m_s[..., ::-1].copy(), fl_f, True))
                for f, m, fl, flip in passes:
                    self._run(f[None], m[None], n_objects[None], fl[None], return_probs=True,
                              accumulate_into=(acc, flip))
                    n_passes += 1
                if flows_out is None:
                    flows_out = fl_s if fs == 1.0 else resize_bilinear(
                        torch.from_numpy(fl_s), (H, W)).numpy() / fs
            probs = acc[:T].cpu().numpy() / n_passes
        probs[0] = masks[0]
        return flows_out, probs
