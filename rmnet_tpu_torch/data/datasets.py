"""Datasets and the loader (counterpart of rmnet_tpu/data/datasets.py;
reference utils/data_loaders.py).

The reference's indexing-file formats (DAVIS.json, YouTube-VOS meta.json,
the image sets' id lists), dataset concatenation with the ``'DAVISx5'``
repeat syntax, and a thread-pool loader with ordered batches, a bounded
in-flight window and per-batch seeded RNG streams. The TRAIN subset samples
``TRAIN.N_MAX_FRAMES`` frames ``frame_step`` apart (the curriculum sets the
step) and runs the training transforms; the static-image sets (PASCAL VOC,
ECSSD, MSRA10K, COCO, ADE20K, DAVIS_FRAMES) make a clip of one image, drawn
with replacement, each frame with its own affine.
"""

from __future__ import annotations

import json
import queue
import random
import threading
from enum import Enum, unique
from typing import Any, Sequence, Tuple

import numpy as np

from rmnet_tpu_torch.data import transforms as T
from rmnet_tpu_torch.data.io import IO
from rmnet_tpu_torch.data.rng import clear_stream, pyrand, seed_stream


@unique
class DatasetSubset(Enum):
    TRAIN = 0
    TEST = 1
    VAL = 2


class VideoDataset:
    """A video dataset over a file list (reference Dataset,
    utils/data_loaders.py:28-92): ``n_max_frames`` frames of each video,
    or every frame when it is 0."""

    def __init__(self, file_list, transforms=None, options=None):
        self.ignore_idx = options["ignore_idx"]
        self.n_max_frames = options["n_max_frames"]
        self.n_max_objects = options["n_max_objects"]
        self.file_list = file_list
        self.transforms = transforms
        self.frame_step = 1

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, idx):
        video = self.file_list[idx]
        frames, masks, opt_flows, n_objects = [], [], [], []

        for fi in self._get_frame_indexes(video["n_frames"], self.n_max_frames):
            frame = np.array(IO.get(video["frames"][fi]).convert("RGB"))
            frames.append(frame)
            mask = IO.get(video["masks"][fi]) if fi < len(video["masks"]) else None
            mask = (
                np.array(mask.convert("P"))
                if mask is not None
                else np.zeros(frame.shape[:-1], np.uint8)
            )
            masks.append(mask)
            flow = (
                IO.get(video["optical_flow"][fi]) if "optical_flow" in video else None
            )
            flow = flow if flow is not None else np.zeros(frame.shape[:-1] + (2,), np.float32)
            opt_flows.append(np.asarray(flow, np.float32))

        # cumulative distinct-object count per frame (utils/data_loaders.py:58-65)
        mask_indexes: set = set()
        for m in masks:
            mi = np.unique(m)
            mask_indexes.update(mi[mi != self.ignore_idx].tolist())
            n_objects.append(min(len(mask_indexes) - 1, self.n_max_objects))

        if self.transforms is not None:
            frames, masks, opt_flows = self.transforms(frames, masks, opt_flows)

        return video["name"], np.array(n_objects), frames, masks, opt_flows

    def _get_frame_indexes(self, n_frames, n_max_frames):
        if n_max_frames == 0:
            return list(range(n_frames))
        if n_frames <= n_max_frames:
            # short videos: drawn with replacement (YouTube-VOS d177e9878a has
            # 2 frames; reference utils/data_loaders.py:77-79)
            return pyrand().choices(list(range(n_frames)), k=n_max_frames)
        begin_ub = n_frames - (n_max_frames - 1) * self.frame_step - 1
        begin = pyrand().randint(0, begin_ub) if begin_ub > 0 else 0
        end = begin + (n_max_frames - 1) * self.frame_step
        if end >= n_frames:
            return sorted(pyrand().sample(list(range(n_frames)), n_max_frames))
        return list(range(begin, end + 1, self.frame_step))

    def set_frame_step(self, frame_step):
        self.frame_step = frame_step


class MultipleDatasets:
    """Concatenation with a per-dataset repeat factor; a repeat below 1
    samples at random (reference utils/data_loaders.py:95-124)."""

    def __init__(self, datasets: Sequence[Tuple[Any, float]]):
        self.datasets = list(datasets)
        self.indexes = [0]
        for dataset, repeat in self.datasets:
            self.indexes.append(self.indexes[-1] + int(len(dataset) * repeat))

    def __len__(self):
        return self.indexes[-1]

    def __getitem__(self, idx):
        d_idx = 0
        for i, end in enumerate(self.indexes):
            if idx < end:
                d_idx = i - 1
                break
        dataset, repeat = self.datasets[d_idx]
        if repeat >= 1:
            return dataset[(idx - self.indexes[d_idx]) % len(dataset)]
        return dataset[pyrand().randint(0, len(dataset) - 1)]

    def set_frame_step(self, frame_step):
        for d, _ in self.datasets:
            d.set_frame_step(frame_step)


def _train_video_pipeline(cfg, video_affine=True):
    aug = cfg.TRAIN.AUGMENTATION
    deg = aug.AFFINE_VIDEO_DEGREES if video_affine else aug.AFFINE_IMAGE_DEGREES
    trn = aug.AFFINE_VIDEO_TRANSLATE if video_affine else aug.AFFINE_IMAGE_TRANSLATE
    scl = aug.AFFINE_VIDEO_SCALE if video_affine else aug.AFFINE_IMAGE_SCALE
    shr = aug.AFFINE_VIDEO_SHEARS if video_affine else aug.AFFINE_IMAGE_SHEARS
    return T.Compose([
        {"callback": "Resize", "parameters": {
            "size": aug.RESIZE_SIZE, "keep_ratio": aug.RESIZE_KEEP_RATIO}},
        {"callback": "RandomAffine", "parameters": {
            "degrees": deg, "translate": trn, "scale": scl, "shears": shr,
            "frame_fill_color": aug.AFFINE_IMAGE_FILL_COLOR,
            "mask_fill_color": aug.AFFINE_MASK_FILL_COLOR,
            "optical_flow_fill_color": aug.AFFINE_FLOW_FILL_COLOR}},
        {"callback": "RandomCrop", "parameters": {
            "height": aug.CROP_HSIZE, "width": aug.CROP_WSIZE,
            "ignore_idx": cfg.CONST.IGNORE_IDX}},
        {"callback": "ReorganizeObjectID", "parameters": {
            "ignore_idx": cfg.CONST.IGNORE_IDX}},
        {"callback": "ToOneHot", "parameters": {
            "shuffle": True, "n_objects": cfg.TRAIN.N_MAX_OBJECTS}},
        {"callback": "ColorJitter", "parameters": {
            "brightness": aug.COLOR_BRIGHTNESS, "contrast": aug.COLOR_CONTRAST,
            "saturation": aug.COLOR_SATURATION, "hue": aug.COLOR_HUE}},
        {"callback": "Normalize", "parameters": {
            "mean": cfg.CONST.DATASET_MEAN, "std": cfg.CONST.DATASET_STD}},
        {"callback": "RandomPermuteRGB", "parameters": None},
        {"callback": "ToArrays", "parameters": None},
    ])


def _test_video_pipeline(cfg):
    return T.Compose([
        {"callback": "ReorganizeObjectID", "parameters": {
            "ignore_idx": cfg.CONST.IGNORE_IDX}},
        {"callback": "ToOneHot", "parameters": {
            "shuffle": False, "n_objects": cfg.TEST.N_MAX_OBJECTS}},
        {"callback": "Normalize", "parameters": {
            "mean": cfg.CONST.DATASET_MEAN, "std": cfg.CONST.DATASET_STD}},
        {"callback": "ToArrays", "parameters": None},
    ])


class _VideoSet:
    """A video dataset's subsets: TRAIN through the training pipeline,
    TEST and VAL through the test pipeline."""

    SUBSETS = {}

    def get_dataset(self, subset: DatasetSubset):
        file_list = self._get_file_list(self.cfg, self.SUBSETS[subset.name])
        if subset == DatasetSubset.TRAIN:
            transforms = _train_video_pipeline(self.cfg)
            n_max_frames = self.cfg.TRAIN.N_MAX_FRAMES
            n_max_objects = self.cfg.TRAIN.N_MAX_OBJECTS
        else:
            transforms = _test_video_pipeline(self.cfg)
            n_max_frames = 0
            n_max_objects = self.cfg.TEST.N_MAX_OBJECTS
        return VideoDataset(file_list, transforms, {
            "ignore_idx": self.cfg.CONST.IGNORE_IDX,
            "n_max_frames": n_max_frames,
            "n_max_objects": n_max_objects,
        })


class DavisDataset(_VideoSet):
    SUBSETS = {"TRAIN": "train", "VAL": "val", "TEST": "test"}

    def __init__(self, cfg):
        self.cfg = cfg
        with open(cfg.DATASETS.DAVIS.INDEXING_FILE_PATH) as f:
            self.videos = json.load(f)

    def _get_file_list(self, cfg, subset):
        paths = cfg.DATASETS.DAVIS
        file_list = []
        for v in self.videos[subset]:
            n = v["n_frames"]
            file_list.append({
                "name": f"DAVIS/{v['name']}",
                "n_frames": n,
                "frames": [paths.IMG_FILE_PATH % (v["name"], i) for i in range(n)],
                "masks": [paths.ANNOTATION_FILE_PATH % (v["name"], i) for i in range(n)],
                "optical_flow": [paths.OPTICAL_FLOW_FILE_PATH % (v["name"], i)
                                 for i in range(n)],
            })
        return file_list


class YoutubeVosDataset(_VideoSet):
    SUBSETS = {"TRAIN": "train", "VAL": "valid", "TEST": "test"}

    def __init__(self, cfg):
        self.cfg = cfg

    def _get_file_list(self, cfg, subset):
        paths = cfg.DATASETS.YOUTUBE_VOS
        with open(paths.INDEXING_FILE_PATH % subset) as f:
            meta = json.load(f)
        file_list = []
        for name, video in meta.get("videos", {}).items():
            frame_indexes: set = set()
            for _, obj in video["objects"].items():
                frame_indexes.update(obj["frames"])
            frame_indexes = sorted(frame_indexes)
            file_list.append({
                "name": f"YouTubeVOS/{name}",
                "n_frames": len(frame_indexes),
                "frames": [paths.IMG_FILE_PATH % (subset, name, i) for i in frame_indexes],
                "masks": [paths.ANNOTATION_FILE_PATH % (subset, name, i)
                          for i in frame_indexes],
                "optical_flow": [paths.OPTICAL_FLOW_FILE_PATH % (subset, name, i)
                                 for i in frame_indexes],
            })
        return file_list


class ImageDataset:
    """A static-image pretraining set: each image is a video of one frame;
    drawing frames with replacement and an affine per frame make a clip of
    ``TRAIN.N_MAX_FRAMES`` (reference utils/data_loaders.py:412-492)."""

    def get_dataset(self, subset: DatasetSubset):
        if subset != DatasetSubset.TRAIN:
            raise ValueError("ONLY DatasetSubset.TRAIN is available for ImageDataset.")
        return VideoDataset(self._get_file_list(self.cfg),
                            _train_video_pipeline(self.cfg, video_affine=False), {
            "ignore_idx": self.cfg.CONST.IGNORE_IDX,
            "n_max_frames": self.cfg.TRAIN.N_MAX_FRAMES,
            "n_max_objects": self.cfg.TRAIN.N_MAX_OBJECTS,
        })

    @staticmethod
    def _simple_list(prefix, ids, img_tpl, ann_tpl):
        return [{
            "name": f"{prefix}/{i}",
            "n_frames": 1,
            "frames": [img_tpl % i],
            "masks": [ann_tpl % i],
        } for i in ids]


class _ListedImages(ImageDataset):
    """An image set indexed by a text file of image ids, one per line."""

    NAME, PREFIX = "", ""
    # PASCAL VOC's list ends with a newline that the reference drops
    DROP_LAST_LINE = False

    def __init__(self, cfg):
        self.cfg = cfg
        with open(getattr(cfg.DATASETS, self.NAME).INDEXING_FILE_PATH) as f:
            self.images = f.read().split("\n")
        if self.DROP_LAST_LINE:
            self.images = self.images[:-1]

    def _get_file_list(self, cfg):
        paths = getattr(cfg.DATASETS, self.NAME)
        return self._simple_list(self.PREFIX, self.images, paths.IMG_FILE_PATH,
                                 paths.ANNOTATION_FILE_PATH)


class PascalVocDataset(_ListedImages):
    NAME, PREFIX, DROP_LAST_LINE = "PASCAL_VOC", "VOC", True


class Msra10kDataset(_ListedImages):
    NAME, PREFIX = "MSRA10K", "MSRA10K"


class MscocoDataset(_ListedImages):
    NAME, PREFIX = "MSCOCO", "MSCOCO"


class Ade20kDataset(_ListedImages):
    NAME, PREFIX = "ADE20K", "ADE20K"


class EcssdDataset(ImageDataset):
    """ECSSD: images 0001..N_IMAGES, no index file."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.images = ["%04d" % i for i in range(1, cfg.DATASETS.ECSSD.N_IMAGES + 1)]

    def _get_file_list(self, cfg):
        return self._simple_list("ECSSD", self.images, cfg.DATASETS.ECSSD.IMG_FILE_PATH,
                                 cfg.DATASETS.ECSSD.ANNOTATION_FILE_PATH)


class DavisFrameDataset(ImageDataset):
    """Every frame of DAVIS's train videos as a still image."""

    def __init__(self, cfg):
        self.cfg = cfg
        with open(cfg.DATASETS.DAVIS.INDEXING_FILE_PATH) as f:
            self.videos = json.load(f)["train"]

    def _get_file_list(self, cfg):
        paths = cfg.DATASETS.DAVIS
        return [{
            "name": f"DAVIS/{v['name']}/{i}",
            "n_frames": 1,
            "frames": [paths.IMG_FILE_PATH % (v["name"], i)],
            "masks": [paths.ANNOTATION_FILE_PATH % (v["name"], i)],
        } for v in self.videos for i in range(v["n_frames"])]


class DatasetCollector:
    """Registry and the 'NAMExN' repeat syntax (reference
    utils/data_loaders.py:657-688)."""

    DATASET_LOADER_MAPPING = {
        "DAVIS": DavisDataset,
        "DAVIS_FRAMES": DavisFrameDataset,
        "YOUTUBE_VOS": YoutubeVosDataset,
        "PASCAL_VOC": PascalVocDataset,
        "ECSSD": EcssdDataset,
        "MSRA10K": Msra10kDataset,
        "MSCOCO": MscocoDataset,
        "ADE20K": Ade20kDataset,
    }

    @classmethod
    def get_dataset(cls, cfg, dataset, subset: DatasetSubset):
        if isinstance(dataset, str):
            return cls.DATASET_LOADER_MAPPING[dataset](cfg).get_dataset(subset)
        datasets = []
        for dn in dataset:
            x_index = dn.rfind("x")
            repeat = float(dn[x_index + 1:]) if x_index != -1 else 1
            name = dn[:x_index] if x_index != -1 else dn
            loader = cls.DATASET_LOADER_MAPPING[name](cfg).get_dataset(subset)
            datasets.append((loader, int(repeat) if repeat >= 1 else repeat))
        return MultipleDatasets(datasets)


class DataLoader:
    """Batching loader: shuffle, drop_last, ``n_workers`` decode threads.

    The threads decode batches concurrently (Pillow and numpy release the
    GIL in decoding and array math); at most 2 * n_workers decoded batches
    wait unconsumed, and batches come out in order whichever worker finishes
    first. ``n_workers=0`` decodes on the consumer's thread."""

    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False, seed=None,
                 n_workers=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.n_workers = n_workers
        self.rng = random.Random(seed)
        # the decode streams' bases come from their own rng, so the shuffle
        # stream (self.rng) is the JAX package's
        self._decode_rng = random.Random(
            None if seed is None else (int(seed) ^ 0x5EED5EED)
        )

    def __len__(self):
        n, b = len(self.dataset), self.batch_size
        return n // b if self.drop_last else -(-n // b)

    @staticmethod
    def collate(samples):
        names = [s[0] for s in samples]
        n_objects = np.stack([s[1] for s in samples])
        frames = np.stack([s[2] for s in samples])
        masks = np.stack([s[3] for s in samples])
        flows = np.stack([s[4] for s in samples])
        return names, n_objects, frames, masks, flows

    def __iter__(self):
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [
            order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        # per-epoch base of the per-batch decode streams: decoded data
        # depends only on (loader seed, epoch, batch index)
        epoch_seed = self._decode_rng.getrandbits(31)

        def decode(bi, b):
            seed_stream(epoch_seed * 1000003 + bi)
            try:
                return self.collate([self.dataset[i] for i in b])
            finally:
                # never leave the seeded stream on the caller's thread (the
                # synchronous path decodes there)
                clear_stream()

        n_workers = int(self.n_workers)
        if n_workers <= 0:
            for bi, b in enumerate(batches):
                yield decode(bi, b)
            return

        # workers take (batch index, indexes) tasks and leave results keyed
        # by batch index; the consumer takes batch i only after i-1. A
        # semaphore bounds the decoded but unconsumed batches.
        max_inflight = max(2, 2 * n_workers)
        work_q: "queue.Queue" = queue.Queue()
        done: dict = {}
        done_cv = threading.Condition()
        sem = threading.Semaphore(max_inflight)
        abandoned = [False]

        def feeder():
            for task in enumerate(batches):
                sem.acquire()
                if abandoned[0]:
                    break
                work_q.put(task)
            for _ in range(n_workers):
                work_q.put(None)

        def worker():
            while True:
                task = work_q.get()
                if task is None:
                    return
                bi, b = task
                try:
                    res = decode(bi, b)
                except Exception as ex:  # raised on the consumer's thread
                    res = ex
                with done_cv:
                    done[bi] = res
                    done_cv.notify_all()

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [threading.Thread(target=worker, daemon=True)
                    for _ in range(n_workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(len(batches)):
                with done_cv:
                    while bi not in done:
                        done_cv.wait()
                    item = done.pop(bi)
                sem.release()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # unblock the feeder if the consumer left the iterator early
            abandoned[0] = True
            for _ in range(max_inflight):
                sem.release()
