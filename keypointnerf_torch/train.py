"""Train / validate CLI of the port.

    python -m keypointnerf_torch.train --config configs/zju.json \
        --set data.dataset=synthetic data.image_size=512 --allow_random_vgg --max_steps 8
    python -m keypointnerf_torch.train --config configs/zju.json --run_val --model_ckpt DIR
    python -m keypointnerf_torch.train --config configs/synthetic.json --fast_dev_run \
        --device cpu --set model.n_coarse=4 model.n_fine=4 ...
    python -m keypointnerf_torch.train --config configs/zju.json --devices 2 ...
    python -m keypointnerf_torch.train --config configs/zju.json \
        --coordinator host0:29500 --num_processes 4 --process_id 0 ...

Port of the JAX package's `train.py` (reference train.py:15-80): builds the
model and the `Trainer` from a config, auto-resumes from the newest
checkpoint, and trains or (`--run_val`) restores the best step and scores
the val set with `evaluation.run_eval`. It runs on the card unless
`--device` names another device.

More than one device is one process a device (`parallel/`): `--devices N`
starts N ranks on this host (torch.multiprocessing), rank i on `cuda:i`
(or all on the CPU with `--device cpu`); `--coordinator host:port
--num_processes P --process_id i` makes this process rank i of a
P-process group, on `--device` or `cuda:<i>`. The backend is NCCL for
CUDA (a card a rank) and gloo for the CPU. `--sharded_eval` splits each
eval image's rays over the ranks.
"""
from __future__ import annotations

import argparse
import json
import os


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="KeypointNeRF trainer (PyTorch port)")
    p.add_argument("--config", type=str, default=None, help="JSON/YAML experiment config")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--run_val", action="store_true", help="run test/eval instead of training")
    p.add_argument("--fast_dev_run", action="store_true", help="2-step smoke run")
    p.add_argument("--model_ckpt", type=str, default=None, help="checkpoint dir to restore")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    p.add_argument("--sharded_eval", action="store_true",
                   help="partition eval-render rays across the ranks")
    p.add_argument("--auto_cull_budget", type=int, default=0, metavar="N",
                   help="probe N samples and raise the exact empty-ray cull budget to cover "
                        "this dataset's visual hull; 0 = use the config budget")
    p.add_argument("--devices", type=int, default=None,
                   help="number of devices of this host to train on: one rank each")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0, for a multi-process group")
    p.add_argument("--num_processes", type=int, default=None,
                   help="ranks in the group (one device each)")
    p.add_argument("--process_id", type=int, default=None, help="this process's rank")
    p.add_argument("--no_tensorboard", action="store_true",
                   help="write metrics.jsonl only (no TensorBoard events)")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted config overrides, e.g. optim.learning_rate=1e-3")
    p.add_argument("--allow_random_vgg", action="store_true",
                   help="train with random frozen VGG features when no pretrained "
                        "vgg_weights are configured (NOT the reference objective: its "
                        "perceptual term uses ImageNet VGG19)")
    return p


def parse_overrides(pairs):
    """KEY=VALUE strings -> {key: JSON value, or the string itself}."""
    out = {}
    for pair in pairs:
        k, _, v = pair.partition("=")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def build_datasets(cfg):
    """(train, val) datasets of `cfg.data`."""
    if cfg.data.dataset == "synthetic":
        from .data import SyntheticConfig, SyntheticDataset

        sc = SyntheticConfig(image_size=cfg.data.image_size)
        return SyntheticDataset(sc, length=64), SyntheticDataset(sc, length=cfg.data.max_len_val)
    if cfg.data.dataset == "zju":
        from .data import ZJUDataset, ZJUTestDataset

        train = ZJUDataset(cfg.data.data_root, "train", image_ratio=cfg.data.image_ratio,
                           n_source_views=cfg.data.n_source_views)
        val = ZJUTestDataset(cfg.data.data_root, "val", sample_frame=cfg.data.sample_frame,
                             max_len=cfg.data.max_len_val, image_ratio=cfg.data.image_ratio)
        return train, val
    raise ValueError(f"unknown dataset {cfg.data.dataset}")


def check_process_args(args) -> None:
    """Raise ValueError for multi-process flags that do not fit together."""
    P = args.num_processes
    if args.process_id is not None and P is None:
        raise ValueError("--process_id needs --num_processes")
    if P is not None and P > 1 and args.coordinator is None:
        raise ValueError(f"--num_processes {P} needs --coordinator host:port (rank 0's address)")
    if args.devices is not None and args.devices < 1:
        raise ValueError(f"--devices must be at least 1, got {args.devices}")
    if args.devices not in (None, 1) and P not in (None, args.devices):
        raise ValueError(f"--devices {args.devices} starts that many ranks on this host; "
                         f"--num_processes {P} joins a group: give one of them")


def _rank_main(i, argv, n, port):
    main(list(argv) + ["--coordinator", f"localhost:{port}", "--num_processes", str(n),
                       "--process_id", str(i)])


def launch_local(args, argv) -> None:
    """`--devices N`: N ranks on this host, each running this CLI as rank i
    of an N-process group at a free localhost port."""
    import torch
    import torch.multiprocessing as mp

    from .parallel import free_port

    n = args.devices
    if torch.device(args.device or "cuda").type == "cuda":
        count = torch.cuda.device_count()
        if n > count:
            raise ValueError(
                f"--devices {n} asks for {n} CUDA ranks, but there are {count} CUDA device(s): "
                "NCCL puts one rank on each card")
    mp.spawn(_rank_main, args=(list(argv), n, free_port()), nprocs=n, join=True)


def main(argv=None):
    """Run the CLI; returns the Trainer (None for the process that
    launches `--devices N` ranks)."""
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    args = create_parser().parse_args(argv)
    check_process_args(args)
    if args.devices not in (None, 1) and args.num_processes is None:
        launch_local(args, argv)
        return None

    from .device import resolve_device
    from .parallel import default_backend, destroy, initialize_distributed, rank_device
    from .utils import load_config

    overrides = parse_overrides(args.set)
    if args.data_root:
        overrides["data.data_root"] = args.data_root
    if args.out_dir:
        overrides["out_dir"] = args.out_dir
    cfg = load_config(args.config, overrides)
    device = resolve_device(args.device)
    joined = False
    if args.num_processes not in (None, 1):
        backend = default_backend(device)
        if device.type == "cuda" and device.index is None:
            device = rank_device(args.process_id)
        joined = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                        backend, device)
    try:
        return _run(args, cfg, device)
    finally:
        if joined:
            destroy()


def _run(args, cfg, device):
    """Build and train, or score with --run_val, on `device` (in the
    process group, if one was joined)."""
    from .evaluation import run_eval
    from .models import VGG19Features, load_torch_vgg19
    from .training.loop import Trainer
    from .utils import CheckpointManager, get_model

    if cfg.purpose == "eval" and not args.run_val:
        # eval / serve presets are a training trap: their eval-only flags
        # are inert in training
        print("WARNING: config purpose='eval': this preset is tuned for inference. In "
              "training, gather_lerp / fused_map_half / topk / cull_empty_rays ratios are "
              "inert, and fused_feature_map slows the train step. Train with "
              "configs/zju.json instead.")

    vgg = None
    if cfg.vgg_weights:
        if not os.path.exists(cfg.vgg_weights):
            raise FileNotFoundError(f"cfg.vgg_weights={cfg.vgg_weights!r} does not exist")
        vgg = load_torch_vgg19(cfg.vgg_weights, device=device)
    elif cfg.loss.lambda_vgg > 0.0 and not args.run_val:
        # the reference objective is 0.5 * VGG of the training signal;
        # random frozen features make it a different objective: opt in
        if not args.allow_random_vgg:
            raise SystemExit(
                "loss.lambda_vgg > 0 but no vgg_weights configured. Either point "
                "cfg.vgg_weights at a torchvision vgg19 state_dict, set --set "
                "loss.lambda_vgg=0, or pass --allow_random_vgg to knowingly train with "
                "random frozen VGG features.")
        print("WARNING: no vgg_weights configured; using random frozen VGG features")
        vgg = VGG19Features(device=device)

    model = get_model(cfg, device=device)
    train_data, val_data = build_datasets(cfg)
    trainer = Trainer(cfg, model, train_data, val_data, vgg=vgg,
                      tensorboard=not args.no_tensorboard)

    if args.model_ckpt:
        # an explicit checkpoint dir; eval restores the best val_total_loss
        # step, training the latest
        restored, step = CheckpointManager(args.model_ckpt).restore(
            best=args.run_val, map_location=device)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {args.model_ckpt}")
        trainer.state.load_state_dict(restored)
        print(f"restored {'best' if args.run_val else 'latest'} step {step}")
    elif args.run_val:
        restored, step = trainer.ckpt.restore(best=True, map_location=device)
        if restored is not None:
            trainer.state.load_state_dict(restored)
            print(f"restored best-val step {step}")

    if args.run_val:
        run_eval(cfg, model, val_data, sharded=args.sharded_eval,
                 auto_cull_budget=args.auto_cull_budget, step=trainer.state.step)
        return trainer
    trainer.fit(max_steps=2 if args.fast_dev_run else args.max_steps)
    return trainer


if __name__ == "__main__":
    main()
