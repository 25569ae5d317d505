"""Dataset index builders (counterpart of rmnet_tpu/data/build_index.py).

The datasets read pre-built index files: ``DAVIS.json`` (video name and
frame count per subset, reference utils/data_loaders.py:148-262), a
YouTube-VOS ``meta.json`` per subset, and plain-text image-id lists for the
static-image pretraining sets (``msra10k.txt`` and the like,
utils/data_loaders.py:495-654). These helpers rebuild them from a dataset
directory:

    python -m rmnet_tpu_torch.data.build_index davis ROOT OUT.json
    python -m rmnet_tpu_torch.data.build_index ytvos ROOT OUT.json --subset train
    python -m rmnet_tpu_torch.data.build_index imagelist DIR OUT.txt
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")

# DAVIS-2017 split files -> index keys (ImageSets/2017/<split>.txt)
_DAVIS_SPLITS = (
    ("train", "train.txt"),
    ("val", "val.txt"),
    ("test", "test-dev.txt"),
    ("test-challenge", "test-challenge.txt"),
)


def _frame_key(stem: str):
    """Sort/compare key for frame stems: numeric stems compare numerically
    ('100' after '95'); YT-VOS's zero-padded stems are unaffected, but
    re-exported layouts without fixed-width names stay correct."""
    return (0, int(stem), stem) if stem.isdigit() else (1, 0, stem)


def count_frames(video_dir: str) -> int:
    """Number of image frames in a video directory."""
    if not os.path.isdir(video_dir):
        return 0
    return sum(
        1 for f in os.listdir(video_dir) if f.lower().endswith(_IMG_EXTS)
    )


def build_davis_index(
    root: str,
    year: str = "2017",
    resolution: str = "480p",
) -> Dict[str, List[dict]]:
    """Build the DAVIS.json-style index from a DAVIS directory tree.

    Reads ``ImageSets/<year>/<split>.txt`` video lists and counts frames in
    ``JPEGImages/<resolution>/<video>/``. Missing split files yield empty
    lists (the reference index has train 60 / val 30 / test 30 /
    test-challenge 30 entries, SURVEY §2.4).
    """
    index: Dict[str, List[dict]] = {}
    for key, filename in _DAVIS_SPLITS:
        split_path = os.path.join(root, "ImageSets", year, filename)
        videos: List[dict] = []
        if os.path.isfile(split_path):
            with open(split_path, "r", encoding="utf-8") as f:
                names = [line.strip() for line in f if line.strip()]
            for name in names:
                n = count_frames(os.path.join(root, "JPEGImages", resolution, name))
                videos.append({"name": name, "n_frames": n})
        index[key] = videos
    return index


def build_ytvos_index(root: str, subset: str = "valid") -> Dict[str, dict]:
    """Regenerate a YouTube-VOS ``meta.json`` from a dataset directory tree.

    YouTube-VOS ships ``<subset>/meta.json`` alongside the data; the
    reference reads it directly (utils/data_loaders.py:377-409: frame
    indexes are the union of per-object ``frames`` lists). When only the
    images/annotations are on disk, this rebuilds the consumed subset of
    that schema — ``{"videos": {name: {"objects": {id: {"frames": [...]}}}}}``
    — by scanning palette annotation PNGs:

      * ``train``: an object's frames are exactly the annotation frames in
        which its id appears (train is densely annotated).
      * ``valid``/``test``: only first-appearance annotations exist, so an
        object's frames are every JPEG frame from its first annotated frame
        onward — the frames a VOS method must predict for that object.

    Layout expected (official): ``<root>/<subset>/JPEGImages/<video>/*.jpg``
    and ``<root>/<subset>/Annotations/<video>/*.png``.
    """
    import numpy as np
    from PIL import Image

    ann_root = os.path.join(root, subset, "Annotations")
    img_root = os.path.join(root, subset, "JPEGImages")
    if not os.path.isdir(ann_root):
        raise FileNotFoundError(f"no Annotations directory at {ann_root}")
    videos: Dict[str, dict] = {}
    for name in sorted(os.listdir(ann_root)):
        vdir = os.path.join(ann_root, name)
        if not os.path.isdir(vdir):
            continue
        ann_frames = sorted(
            (os.path.splitext(f)[0] for f in os.listdir(vdir)
             if f.lower().endswith(".png")), key=_frame_key,
        )
        img_dir = os.path.join(img_root, name)
        if os.path.isdir(img_dir):
            all_frames = sorted(
                (os.path.splitext(f)[0] for f in os.listdir(img_dir)
                 if f.lower().endswith(_IMG_EXTS)), key=_frame_key,
            )
        else:
            all_frames = ann_frames
        obj_frames: Dict[str, List[str]] = {}
        for stem in ann_frames:
            mask = np.asarray(Image.open(os.path.join(vdir, stem + ".png")))
            for oid in np.unique(mask):
                if oid == 0 or oid == 255:  # background / ignore
                    continue
                obj_frames.setdefault(str(int(oid)), []).append(stem)
        objects: Dict[str, dict] = {}
        for oid, frames in sorted(obj_frames.items(), key=lambda kv: int(kv[0])):
            if subset == "train":
                objects[oid] = {"frames": frames}
            else:
                first = _frame_key(frames[0])
                objects[oid] = {
                    "frames": [f for f in all_frames if _frame_key(f) >= first]
                }
        videos[name] = {"objects": objects}
    return {"videos": videos}


def write_ytvos_index(root: str, out_path: str, subset: str = "valid") -> str:
    """Build and save a YouTube-VOS meta.json; returns the output path."""
    meta = build_ytvos_index(root, subset=subset)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    return out_path


def build_file_list(directory: str) -> List[str]:
    """Sorted image-id stems in a directory (the txt-list format of the
    msra10k/mscoco/ade20k pretrain indexes)."""
    if not os.path.isdir(directory):
        return []
    stems = [
        os.path.splitext(f)[0]
        for f in os.listdir(directory)
        if f.lower().endswith(_IMG_EXTS)
    ]
    return sorted(stems)


def write_davis_index(root: str, out_path: str, **kwargs) -> str:
    """Build and save a DAVIS index JSON; returns the output path."""
    index = build_davis_index(root, **kwargs)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(index, f, indent=1)
    return out_path


def write_file_list(directory: str, out_path: str) -> str:
    """Build and save an image-id list (one stem per line)."""
    ids = build_file_list(directory)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(ids) + ("\n" if ids else ""))
    return out_path


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Rebuild dataset index files.")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("davis", help="DAVIS.json from a DAVIS root")
    d.add_argument("root")
    d.add_argument("out")
    d.add_argument("--year", default="2017")
    d.add_argument("--resolution", default="480p")
    y = sub.add_parser("ytvos", help="meta.json from a YouTube-VOS root")
    y.add_argument("root")
    y.add_argument("out")
    y.add_argument("--subset", default="valid",
                   choices=["train", "valid", "test"])
    i = sub.add_parser("imagelist", help="image-id txt list from a directory")
    i.add_argument("directory")
    i.add_argument("out")
    args = p.parse_args(argv)
    if args.cmd == "davis":
        path = write_davis_index(args.root, args.out, year=args.year,
                                 resolution=args.resolution)
    elif args.cmd == "ytvos":
        path = write_ytvos_index(args.root, args.out, subset=args.subset)
    else:
        path = write_file_list(args.directory, args.out)
    print(path)


if __name__ == "__main__":
    main()
