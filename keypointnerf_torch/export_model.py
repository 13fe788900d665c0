"""Export a trained render program to a `torch.export` artifact.

    python -m keypointnerf_torch.export_model --config configs/zju.json \
        --model_ckpt out/zju/ckpts --out /tmp/kpnerf_render.pt2 \
        --height 512 --width 512

Port of the JAX package's `export_model.py`, with its flags; `--device`
(the card unless named) replaces `--platforms`: the artifact runs on the
device type it was exported for. The output is a self-contained program
(`export.py`): a serving process loads it with
`keypointnerf_torch.export.load_render`, which needs the port's op
registrations (`keypointnerf_torch.ops`) and never the model, and calls it
with (params, src_images, src_masks, src_K, src_R, src_t, kpt3d, bounds,
tar_K, R, t), `params` the model's state_dict. It returns (frames,
cull_overflow); consumers MUST check the overflow guard when the exported
config culls (docs/API.md "Serving contract"). The artifact holds no
weights: this CLI writes the restored state_dict beside it
(`<out>.params.pt`) for the consumer to pass.
"""
from __future__ import annotations

import argparse


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export the render program (PyTorch port)")
    p.add_argument("--config", required=True)
    p.add_argument("--model_ckpt", default=None,
                   help="checkpoint dir (omit = random init smoke export)")
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--chunk", type=int, default=8192)
    p.add_argument("--cameras", type=int, default=0,
                   help="export the multi-camera serving fn over F stacked target cameras "
                        "(encode once, then each camera; 0 = single-camera artifact)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device the artifact runs on (default: the CUDA card)")
    p.add_argument("--set", nargs="*", default=[], help="dotted config overrides")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns {"bytes": artifact size, "out": its path,
    "params": the state_dict file, "step": the restored step or None}."""
    args = create_parser().parse_args(argv)

    import torch

    from .data import SyntheticConfig, make_sample
    from .device import resolve_device
    from .export import export_render
    from .models import ViewBatch
    from .train import parse_overrides
    from .utils import CheckpointManager, get_model, load_config

    device = resolve_device(args.device)
    cfg = load_config(args.config, parse_overrides(args.set))
    model = get_model(cfg, device=device)

    # example shapes: V source views at the configured resolution (only
    # shapes / dtypes are baked into the artifact, not the pixel values)
    sample = make_sample(SyntheticConfig(image_size=cfg.data.image_size,
                                         n_views=cfg.data.n_source_views + 1,
                                         n_kpt=cfg.model.n_kpt), seed=0)
    vb = ViewBatch.from_numpy(sample, device)

    step = None
    if args.model_ckpt:
        restored, step = CheckpointManager(args.model_ckpt).restore(best=True,
                                                                     map_location=device)
        if restored is None:
            raise SystemExit(f"no checkpoint found in {args.model_ckpt}")
        model.load_state_dict(restored["model"])
        print(f"restored best-val step {step}")
    else:
        print("WARNING: exporting randomly-initialized params (smoke export)")

    tar_K, tar_R, tar_t = vb.tar_K, vb.tar_R, vb.tar_t
    if args.cameras > 0:
        stack = lambda x: x.expand((args.cameras,) + x.shape).contiguous()  # noqa: E731
        tar_K, tar_R, tar_t = stack(tar_K), stack(tar_R), stack(tar_t)
    flat_args = (vb.src_images, vb.src_masks, vb.src_K, vb.src_R, vb.src_t,
                 vb.kpt3d, vb.bounds, tar_K, tar_R, tar_t)
    params = model.state_dict()
    blob = export_render(model, params, flat_args, height=args.height, width=args.width,
                         chunk=args.chunk, device=device, multicam=args.cameras > 0)
    with open(args.out, "wb") as f:
        f.write(blob)
    params_path = f"{args.out}.params.pt"
    torch.save(params, params_path)
    print(f"wrote {len(blob) / 1e6:.2f} MB -> {args.out} ({args.height}x{args.width}, "
          f"device={device.type}); params -> {params_path}")
    return {"bytes": len(blob), "out": args.out, "params": params_path, "step": step}


if __name__ == "__main__":
    main()
