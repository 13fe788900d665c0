"""Offline eval CLI: re-score saved pred / gt PNG trees.

    python -m keypointnerf_torch.eval_zju --src_dir out/keypointnerf/images_v3

Port of the JAX package's `eval_zju.py` (reference eval_zju.py:15-52):
globs `{src_dir}/*/gt/*.png` against `pred/` and prints the mean PSNR /
SSIM (`evaluation.eval_saved_images`).
"""
from __future__ import annotations

import argparse

from .evaluation import eval_saved_images


def main(argv=None):
    """Print and return the mean scores of the tree."""
    parser = argparse.ArgumentParser(description="re-score saved pred/gt PNG trees")
    parser.add_argument("--src_dir", type=str, default="./out/keypointnerf/images_v3")
    args = parser.parse_args(argv)
    scores = eval_saved_images(args.src_dir)
    for k, v in scores.items():
        print(f"{k}:\t{v}")
    return scores


if __name__ == "__main__":
    main()
