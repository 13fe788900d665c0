"""Orbit-frame rendering CLI of the port.

    python -m keypointnerf_torch.render_dynamic --config configs/zju.json \
        --data_root /data/zju --model_ckpt out/zju/ckpts [--auto_cull_budget 4]

Counterpart of the root `render_dynamic.py` (reference
render_dynamic.py:13-37), with the same flags plus `--device` (the card
unless it names another), `--im_size` (the orbit frames' side, 512 as
there) and `--max_samples` (the first N loadable test samples only). It
restores the newest checkpoint of `--model_ckpt` (the port's
`CheckpointManager` layout), and for each test frame renders the matching
camera of an `--n_frames` 360° orbit around the SMPL root pose into
`{out_dir}/{name}/video/zju/{human}/{index:06d}.png`, then assembles each
subject's mp4 with ffmpeg where it is installed.
"""
from __future__ import annotations

import argparse
import os


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="KeypointNeRF orbit frames (PyTorch port)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--model_ckpt", type=str, required=True, help="checkpoint dir")
    p.add_argument("--n_frames", type=int, default=90)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--im_size", type=int, default=512, help="orbit frame side in pixels")
    p.add_argument("--max_samples", type=int, default=None,
                   help="render the first N loadable test samples only (default: all)")
    p.add_argument("--auto_cull_budget", type=int, default=0, metavar="N",
                   help="probe N cameras spread over each orbit and raise the exact "
                        "empty-ray cull budget to cover them before rendering "
                        "(render.suggest_cull_budget); 0 = use the config budget")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns {"frames": written paths, "cull_overflow": the
    worst of any frame, "videos": {frame dir: whether its mp4 was made}}."""
    args = create_parser().parse_args(argv)

    import numpy as np

    from .data import ZJUTestDataset
    from .device import resolve_device
    from .models import ViewBatch
    from .render.video import render_orbit, write_video
    from .utils import CheckpointManager, get_model, load_config

    overrides = {}
    if args.data_root:
        overrides["data.data_root"] = args.data_root
    if args.out_dir:
        overrides["out_dir"] = args.out_dir
    cfg = load_config(args.config, overrides)
    device = resolve_device(args.device)

    # test_visualize: one sample a frame (reference config.py + zju_dataset.py:149-151)
    dataset = ZJUTestDataset(cfg.data.data_root, "test", sample_frame=1, sample_camera=6,
                             image_ratio=cfg.data.image_ratio)
    model = get_model(cfg, device=device)
    restored, step = CheckpointManager(args.model_ckpt).restore(map_location=device)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint found in {args.model_ckpt}")
    model.load_state_dict(restored["model"])
    model.eval()
    print(f"loaded checkpoint step {step}")

    dst = os.path.join(cfg.out_dir, cfg.name, "video")
    frames, worst, frame_dirs = [], 0.0, []
    for i in range(len(dataset)):
        if args.max_samples is not None and len(frames) >= args.max_samples:
            break
        sample = dataset[i]
        if sample is None:
            continue
        meta = sample.pop("meta")
        vb = ViewBatch.from_numpy(sample, device)
        sub_dir = os.path.join(dst, "zju", meta["human"])
        if sub_dir not in frame_dirs:
            frame_dirs.append(sub_dir)
        written, overflow = render_orbit(
            model, vb, np.asarray(meta["headpose"]), sub_dir, n_frames=args.n_frames,
            im_size=args.im_size, stride=args.stride,
            frame_indices=[meta["frame_index"] % args.n_frames], make_video=False,
            auto_cull_budget=args.auto_cull_budget)
        frames += written
        worst = max(worst, overflow)
    videos = {d: write_video(d, f"{d}_nvs.mp4") for d in frame_dirs}
    print(f"wrote {len(frames)} orbit frames under {dst}; worst cull_overflow {worst}")
    return {"frames": frames, "cull_overflow": worst, "videos": videos}


if __name__ == "__main__":
    main()
