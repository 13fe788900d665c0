"""ZJU-MoCap filename normalization for subjects 313/315.

The port's own copy of `keypointnerf_tpu/data/preprocess_zju.py`,
counterpart of the reference preprocess/rename_zju.py:15-34: subjects
CoreView_313/315 ship with `Camera (i)` directories whose files embed the
frame id as the 5th underscore-separated token; this renames them to plain
`{frame}.jpg` / `{frame}.png` so the loader can address frames uniformly.

Usage: python -m keypointnerf_torch.data.preprocess_zju --data_dir /data/zju
"""
from __future__ import annotations

import argparse
import os
from os.path import basename, isfile, join

CAM_LIST = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 22, 23]


def rename_subject(data_dir: str, human: str, dry_run: bool = False) -> int:
    roots = [
        join(data_dir, human),
        join(data_dir, human, "mask_cihp"),
        join(data_dir, human, "mask"),
    ]
    n = 0
    for root_path in roots:
        ext = ".png" if basename(root_path) in ("mask_cihp", "mask") else ".jpg"
        for cam_idx in CAM_LIST:
            folder = join(root_path, f"Camera ({cam_idx})")
            if not os.path.isdir(folder):
                continue
            for f in os.listdir(folder):
                src = join(folder, f)
                if not isfile(src):
                    continue
                parts = f.split("_")
                if len(parts) <= 4:
                    continue  # already renamed
                dst = join(folder, f"{parts[4]}{ext}")
                if not dry_run:
                    os.rename(src, dst)
                n += 1
    return n


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args()
    for human in ("CoreView_313", "CoreView_315"):
        n = rename_subject(args.data_dir, human, args.dry_run)
        print(f"{human}: renamed {n} files")


if __name__ == "__main__":
    main()
