"""Streaming VOS inference engine on one GPU (counterpart of
rmnet_tpu/core/engine.py, single-video path).

Weights stay on the device for the engine's lifetime. A video runs as a
Python loop over frames: TinyFlowNet computes the backward flow from the
carried previous frame, then ``RMNetApply.step`` memorizes, reads the ring
bank through the block-sparse flash kernel and segments. The loop reads no
value back from the device; labels (or probabilities) are copied to the
host once, after the last frame.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from rmnet_tpu_torch.models.rmnet import RMNet, RMNetApply
from rmnet_tpu_torch.models.tiny_flownet import TinyFlowNet
from rmnet_tpu_torch.models.weights import build_models  # noqa: F401  (re-export)


def _on_device(module_cls, state: Mapping[str, torch.Tensor], device, dtype):
    with torch.device("meta"):
        net = module_cls()
    net = net.to_empty(device=device)
    net.load_state_dict(state)
    return net.to(dtype).eval().requires_grad_(False)


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

    def update_weights(self, rmnet_state, tflownet_state) -> None:
        """Swap in new checkpoint weights, in place on the device."""
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

    @torch.inference_mode()
    def _run(self, frames, masks, n_objects, flows, return_probs: bool):
        T, K, H, W = masks.shape
        n_objects = np.asarray(n_objects)
        dev, dt = self.device, self.dtype
        n_max = int(np.max(n_objects))
        ks = torch.arange(K, device=dev)
        obj_valid = ((ks >= 1) & (ks <= n_max))[None]          # (1, K)
        any_new, commit = self._video_flags(n_objects, T)
        capacity = self._capacity_for(T, commit)

        # one upload for the whole clip; per frame (1, 3, H, W)
        frames_d = torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(dev)
        frames_d = frames_d.permute(0, 3, 1, 2).contiguous()
        flows_d = None
        if flows is not None:
            flows_d = torch.from_numpy(np.ascontiguousarray(flows, np.float32)).to(dev)
            flows_d = flows_d.permute(0, 3, 1, 2).contiguous()
        masks0 = torch.from_numpy(np.asarray(masks[0], np.float32)).to(dev)[None]
        state = self.apply.init_state(frames_d[:1], masks0, capacity, dtype=dt)

        if return_probs:
            out = torch.empty((T, K, H, W), dtype=torch.float32, device=dev)
            out[0] = masks0[0]
        else:
            out = torch.empty((T, H, W), dtype=torch.uint8, device=dev)
            out[0] = masks0[0].argmax(dim=0)
        for t in range(1, T):
            frame = frames_d[t:t + 1]
            if flows_d is None:
                flow = self.tflownet.pair_forward(frame, state.prev_frame)
            else:
                flow = flows_d[t:t + 1]
            gt = None
            if any_new[t]:
                gt = torch.from_numpy(np.asarray(masks[t], np.float32)).to(dev)[None]
            state, est = self.apply.step(state, frame, flow, gt, bool(any_new[t]),
                                         bool(commit[t - 1]), obj_valid)
            out[t] = est[0].float() if return_probs else est[0].argmax(dim=0)
        return out.cpu().numpy()

    def run_video_labels(self, frames, masks, n_objects, flows=None) -> np.ndarray:
        """frames (T, H, W, 3) normalized float32, masks (T, K, H, W) one-hot
        (frame 0 required), n_objects (T,) -> (T, H, W) uint8 labels.
        ``flows=None`` computes TinyFlowNet flows inside the frame loop."""
        return self._run(frames, masks, n_objects, flows, return_probs=False)

    def run_video(self, frames, masks, n_objects, flows=None) -> np.ndarray:
        """Same inputs -> (T, K, H, W) float32 probabilities."""
        return self._run(frames, masks, n_objects, flows, return_probs=True)
