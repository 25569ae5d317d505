"""Configuration tree of the port: the sections, field names and defaults of
rmnet_tpu/config.py, so that a user's config file for the JAX package
loads unchanged.

  * ``Config.from_file(path)``: a Python file defining ``configure(cfg)``
    (or a module-level ``CFG`` dict) mutates a default tree;
  * ``Config.apply_overrides(["TRAIN.BATCH_SIZE=2", ...])``: dot-path
    overrides with literal-eval values; an unknown field raises
    AttributeError.

Defaults that differ from the JAX package's by design (DEFAULTS_THAT_DIFFER):

  * ``TRAIN.FLASH_ATTENTION = True``: the block-sparse flash read with its
    backward kernel trains on the card; the JAX default is False only
    because its Mosaic kernels cannot compile on a CPU.

Every TRAIN field is read by ``train_net`` and the ``Trainer``
(rmnet_tpu_torch/train.py), or refused by ``check_train_flags`` when its
feature is not ported, so that a config is never trained as a different
model in silence:

  * honoured: the schedule, curriculum, checkpoint gating, augmentation,
    ``BACKBONE_WEIGHTS``, ``RESUME_FULL_STATE``, ``FLASH_ATTENTION``,
    ``REMAT`` ("none", "encoders", "step"; another value raises
    ValueError), ``GRAD_ACCUM_STEPS`` (it must divide ``BATCH_SIZE``),
    ``BF16`` (bfloat16 convolutions on float32 weights) and
    ``USE_BATCH_NORM`` (BatchNorm on batch statistics);
  * refused with NotImplementedError: ``DATA_PARALLEL > 1`` (ROADMAP queue
    1 item 4).
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

DEFAULTS_THAT_DIFFER = ("TRAIN.FLASH_ATTENTION",)


@dataclass
class DavisPaths:
    INDEXING_FILE_PATH: str = "./datasets/DAVIS.json"
    IMG_FILE_PATH: str = "./data/DAVIS/JPEGImages/480p/%s/%05d.jpg"
    ANNOTATION_FILE_PATH: str = "./data/DAVIS/Annotations/480p/%s/%05d.png"
    OPTICAL_FLOW_FILE_PATH: str = "./data/DAVIS/OpticalFlows/480p/%s/%05d.flo"


@dataclass
class YoutubeVosPaths:
    INDEXING_FILE_PATH: str = "./data/YouTubeVOS/%s/meta.json"
    IMG_FILE_PATH: str = "./data/YouTubeVOS/%s/JPEGImages/%s/%s.jpg"
    ANNOTATION_FILE_PATH: str = "./data/YouTubeVOS/%s/Annotations/%s/%s.png"
    OPTICAL_FLOW_FILE_PATH: str = "./data/YouTubeVOS/%s/OpticalFlows/%s/%s.flo"


@dataclass
class ImageSetPaths:
    INDEXING_FILE_PATH: str = ""
    IMG_FILE_PATH: str = ""
    ANNOTATION_FILE_PATH: str = ""
    N_IMAGES: int = 0


@dataclass
class Datasets:
    DAVIS: DavisPaths = field(default_factory=DavisPaths)
    YOUTUBE_VOS: YoutubeVosPaths = field(default_factory=YoutubeVosPaths)
    PASCAL_VOC: ImageSetPaths = field(default_factory=lambda: ImageSetPaths(
        "./datasets/voc_trainval.txt", "./data/voc2012/images/%s.jpg",
        "./data/voc2012/masks/%s.png"))
    ECSSD: ImageSetPaths = field(default_factory=lambda: ImageSetPaths(
        "", "./data/ecssd/images/%s.jpg", "./data/ecssd/masks/%s.png", 1000))
    MSRA10K: ImageSetPaths = field(default_factory=lambda: ImageSetPaths(
        "./datasets/msra10k.txt", "./data/msra10k/images/%s.jpg",
        "./data/msra10k/masks/%s.png"))
    MSCOCO: ImageSetPaths = field(default_factory=lambda: ImageSetPaths(
        "./datasets/mscoco.txt", "./data/coco2017/images/train2017/%s.jpg",
        "./data/coco2017/masks/train2017/%s.png"))
    ADE20K: ImageSetPaths = field(default_factory=lambda: ImageSetPaths(
        "./datasets/ade20k.txt", "./data/ADE20K/images/training/%s.jpg",
        "./data/ADE20K/images/training/%s_seg.png"))


@dataclass
class DatasetSelection:
    TRAIN_DATASET: Any = field(default_factory=lambda: ["YOUTUBE_VOS", "DAVISx5"])
    TEST_DATASET: str = "DAVIS"


@dataclass
class Const:
    RNG_SEED: int = 0
    N_WORKERS: int = 4  # loader decode threads; also Metrics.get's thread pool
    IGNORE_IDX: int = 255
    DATASET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    DATASET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    EXP_NAME: str = "default"
    WEIGHTS: Optional[str] = None


@dataclass
class Dirs:
    OUTPUT_DIR: str = "./output"


@dataclass
class Augmentation:
    RESIZE_SIZE: int = 480
    RESIZE_KEEP_RATIO: bool = True
    CROP_HSIZE: int = 465
    CROP_WSIZE: int = 465
    COLOR_BRIGHTNESS: Optional[Tuple[float, float]] = (0.97, 1.03)
    COLOR_CONTRAST: Optional[Tuple[float, float]] = None
    COLOR_SATURATION: Optional[Tuple[float, float]] = None
    COLOR_HUE: Optional[Tuple[float, float]] = None
    AFFINE_IMAGE_DEGREES: Tuple[float, float] = (-20, 20)
    AFFINE_IMAGE_TRANSLATE: Tuple[float, float] = (0, 0)
    AFFINE_IMAGE_SCALE: Tuple[float, float] = (0.9, 1.1)
    AFFINE_IMAGE_SHEARS: Tuple[float, float] = (-10, 10)
    AFFINE_VIDEO_DEGREES: Tuple[float, float] = (-15, 15)
    AFFINE_VIDEO_TRANSLATE: Tuple[float, float] = (0, 0)
    AFFINE_VIDEO_SCALE: Tuple[float, float] = (1.0, 1.3)
    AFFINE_VIDEO_SHEARS: Tuple[float, float] = (-10, 10)
    AFFINE_IMAGE_FILL_COLOR: Tuple[int, int, int] = (255, 255, 255)
    AFFINE_MASK_FILL_COLOR: int = 255
    AFFINE_FLOW_FILL_COLOR: Tuple[float, float] = (0, 0)


@dataclass
class Train:
    BATCH_SIZE: int = 4
    N_EPOCHS: int = 200
    N_MAX_OBJECTS: int = 3
    N_MAX_FRAMES: int = 3
    USE_RANDOM_FRAME_STEPS: bool = True
    USE_BATCH_NORM: bool = False
    MAX_FRAME_STEPS: int = 20
    KEEP_FRAME_STEPS_THRESHOLD: float = 0.745
    EPOCH_INDEX_FIXING_FRAME_STEPS: int = 75
    N_EPOCHS_KEEP_FRAME_STEPS: int = 3
    NETWORK: str = "RMNet"  # 'RMNet' or 'TinyFlowNet'
    LEARNING_RATE: float = 1e-5
    BETAS: Tuple[float, float] = (0.9, 0.999)
    WEIGHT_DECAY: float = 0.0
    CKPT_SAVE_FREQ: int = 1
    CKPT_SAVE_THRESHOLD: float = 0.71
    MEMORIZE_EVERY: int = 1
    BACKBONE_WEIGHTS: Optional[str] = None
    AUGMENTATION: Augmentation = field(default_factory=Augmentation)
    DATA_PARALLEL: int = 1
    BF16: bool = False
    REMAT: str = "encoders"
    # the block-sparse flash read with its backward kernel; False reads the
    # bank densely
    FLASH_ATTENTION: bool = True
    RESUME_FULL_STATE: bool = True
    GRAD_ACCUM_STEPS: int = 1


@dataclass
class Test:
    # one-hot slots of the loader: N_MAX_OBJECTS + 1, every video
    N_MAX_OBJECTS: int = 10
    VISUALIZE_EVERY: int = 10
    MEMORIZE_EVERY: int = 5
    MAIN_METRIC_NAME: str = "JF-Mean"
    # test-time augmentation (InferenceEngine.multi_scale_inference): the
    # left-right flip and the frame scales whose probabilities are averaged
    FLIP_LR: bool = False
    FRAME_SCALES: Tuple[float, ...] = (1.0,)
    # the videos that in-training validation scores
    TESTING_VIDEOS_INDEXES: Tuple[int, ...] = (0, 2, 3, 8, 10, 18, 19, 24, 27, 29)
    # bank slots; 0 = AUTO: sized per video from its commit count so the
    # bank never evicts, matching the reference's unbounded bank
    MEMORY_CAPACITY: int = 0
    # test_net serves N videos of one frame size as one batch
    # (InferenceEngine.run_video_batch)
    N_STREAMS: int = 1


@dataclass
class Config:
    DATASETS: Datasets = field(default_factory=Datasets)
    DATASET: DatasetSelection = field(default_factory=DatasetSelection)
    CONST: Const = field(default_factory=Const)
    DIR: Dirs = field(default_factory=Dirs)
    TRAIN: Train = field(default_factory=Train)
    TEST: Test = field(default_factory=Test)

    @classmethod
    def from_file(cls, path: Optional[str]) -> "Config":
        cfg = cls()
        if path is None:
            return cfg
        spec = importlib.util.spec_from_file_location("rmnet_user_config", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if hasattr(mod, "configure"):
            mod.configure(cfg)
        elif hasattr(mod, "CFG"):
            cfg.apply_dict(mod.CFG)
        else:
            raise ValueError(f"{path} must define configure(cfg) or CFG dict")
        return cfg

    def apply_dict(self, d, node=None):
        node = node if node is not None else self
        for k, v in d.items():
            if isinstance(v, dict) and dataclasses.is_dataclass(getattr(node, k)):
                self.apply_dict(v, getattr(node, k))
            else:
                setattr(node, k, v)

    def apply_overrides(self, overrides: Sequence[str]) -> "Config":
        for ov in overrides:
            path, _, raw = ov.partition("=")
            node = self
            parts = path.strip().split(".")
            for p in parts[:-1]:
                node = getattr(node, p)
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw  # plain string
            if not hasattr(node, parts[-1]):
                raise AttributeError(f"unknown config field: {path}")
            setattr(node, parts[-1], value)
        return self
