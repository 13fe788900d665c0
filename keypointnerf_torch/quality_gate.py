"""Training-quality gate of the port: train the shipped ZJU recipe (reduced
geometry) on the synthetic rig, score seen / unseen scenes, and assert the
floors in `quality_gate.json` beside this file.

    python -m keypointnerf_torch.quality_gate [--steps 3000] [--seed 125]
        [--write-thresholds] [--device cuda] [--steps-chunk 100]
    python -m keypointnerf_torch.quality_gate --eval-at 3000,10000 --write-trend
    python -m keypointnerf_torch.quality_gate --seed 7 --warmup 500 --write-trend

Counterpart of `scripts/quality_gate.py`, with its protocol: the
configs/zju.json recipe flags (bf16 compute, per-map lookups, the matmul
VJP with K1 for the map gradient, no remat) at gate geometry (128² images
with 4 views, a 32x32-ray patch, 32 + 32 samples, 64 training scenes),
`lambda_vgg` 0 (no VGG weights), Adam at `--lr` with `--clip` and
`--warmup`; then strict f32 full-image renders of seen scenes 0-2 and
unseen scenes 100-102 scored by PSNR / SSIM, and the fast preset
(`fast_preset`, cull budget 0.5) on the same scenes with its PSNR delta.
A fast render whose empty-ray cull overflows exits 1, as does assert mode
below a floor.

The training loop is the port's: the 64 samples sit on the device as one
stack, each step's draws come from `step_generator(seed, step)` through
`TrainDraws.sample` (the patch pools found once), and the host fetches
three numbers a chunk of `--steps-chunk` steps: the last loss and the
largest gradient norm with its step. Nothing else waits on the device
inside a chunk.

Floors: the bf16 step is not bit-deterministic on the card (float atomics
in the backward), so every recorded run is a draw. `--write-thresholds`
appends this run to `runs`; the floors come from the runs at the pinned
seed 125 without clip or warmup, less a margin: the larger of the JAX
gate's (1.0 dB, 0.02 SSIM, 0.3 dB of fast delta) and twice those runs'
spread on each metric. A run reads the thresholds file and rewrites it
whole, so runs that record into one file run one after another.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
THRESHOLD_FILE = os.path.join(HERE, "quality_gate.json")

# gate geometry: reduced from the reference's 64²-ray / 64+64-sample step
# (configs/zju.json) to keep the gate minutes, not hours
IMAGE = 128
PATCH = 32
SAMPLES = 32
N_TRAIN = 64
N_EVAL = 3
UNSEEN_BASE = 100
# the seed assert mode gates at; floors derive from its runs only
GATE_SEED = 125
# the fast preset's cull budget at gate geometry: the gate's 128² close-up
# scenes cover ~0.40 of the image, more than the bench orbit's 0.25
FAST_CULL_BUDGET = 0.5
# rays a chunk of the eval renders
EVAL_CHUNK = 8192
# architecture fields over the zju defaults (none: the full width)
ARCH: dict = {}
# the JAX gate's margins (scripts/quality_gate.py:367)
MARGINS = {"psnr": 1.0, "ssim": 0.02, "fast_delta_psnr": 0.3}


def create_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="training-quality gate (PyTorch port)")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--steps-chunk", type=int, default=100)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--seed", type=int, default=GATE_SEED,
                    help="init + step-draw seed; floors derive from the runs at "
                         f"{GATE_SEED}, other seeds are recorded as cross-seed evidence")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    ap.add_argument("--clip", type=float, default=0.0,
                    help="clip_by_global_norm threshold (0 = off, the reference's "
                         "clip-free Adam); clipped runs never set floors")
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear lr warmup steps (0 = off); warmup runs never set floors")
    ap.add_argument("--log-every-chunk", action="store_true",
                    help="print loss / grad-norm for every step chunk")
    ap.add_argument("--eval-at", default=None,
                    help="comma-separated step counts to evaluate at in one run; "
                         "overrides --steps with the largest")
    ap.add_argument("--write-trend", action="store_true",
                    help="append this run's per-checkpoint metrics to trend_runs")
    ap.add_argument("--write-thresholds", action="store_true",
                    help="record this run and re-derive the floors instead of asserting")
    ap.add_argument("--thresholds", default=THRESHOLD_FILE,
                    help="the floors / runs file (default: quality_gate.json beside "
                         "this module)")
    ap.add_argument("--out_dir", default=None,
                    help="also save the trained run in the Trainer's layout "
                         "(config.json + ckpts/) for eval_zju / train --run_val")
    return ap


def gate_config():
    """The configs/zju.json recipe flags at gate geometry."""
    from .models import KeypointNeRFConfig

    recipe = dict(compute_dtype=torch.bfloat16, patch_h=PATCH, patch_w=PATCH,
                  n_coarse=SAMPLES, n_fine=SAMPLES, remat=False,
                  train_matmul_gather_vjp=True, train_pallas_dmap=True)
    return dataclasses.replace(KeypointNeRFConfig(), **{**recipe, **ARCH})


def stack_samples(samples, device):
    """One (B, ...) device tensor a ViewBatch field."""
    return {k: torch.as_tensor(np.stack([np.asarray(s[k], np.float32) for s in samples]),
                               device=device)
            for k in samples[0] if k != "meta"}


def train_gate(model, loss_cfg, state, stack, pools, seed, steps, chunk):
    """Train `steps` steps in chunks of `chunk`, sample `step % N` of the
    device `stack` at step `step`; yields (steps done, last loss, largest
    grad norm, its step) after each chunk (one fetch from the device)."""
    from .models import ViewBatch
    from .training import TrainDraws, step_generator, train_step_fn

    dev = model.device
    n = next(iter(stack.values())).shape[0]
    for base in range(0, steps, chunk):
        losses, norms = [], []
        for k in range(chunk):
            step = base + k
            i = step % n
            vb = ViewBatch(**{f: t[i] for f, t in stack.items()})
            draws = TrainDraws.sample(model.cfg, vb, step_generator(seed, step, dev),
                                      pool=pools[i])
            err = train_step_fn(model, loss_cfg, state, vb, draws)
            losses.append(err["e_all"])
            norms.append(err["grad_norm"])
        gn = torch.stack(norms)
        last, gn_max, gn_at = torch.stack([losses[-1], gn.max(), gn.argmax().float()]).tolist()
        yield base + chunk, last, gn_max, base + int(gn_at)


@torch.no_grad()
def evaluate(train_model, scfg, device, at_step):
    """Seen / unseen strict f32 PSNR / SSIM and the fast preset's PSNR and
    delta, each a mean over N_EVAL scenes; exits 1 on a fast-render cull
    overflow."""
    from .data import make_sample
    from .evaluation import psnr, structural_similarity
    from .models import KeypointNeRF, ViewBatch, fast_preset
    from .render import render_image

    cfg = train_model.cfg
    state = train_model.state_dict()
    eval_model = KeypointNeRF(dataclasses.replace(
        cfg, compute_dtype=torch.float32, remat=False, train_matmul_gather_vjp=False),
        device=device)
    eval_model.load_state_dict(state)
    fast_model = KeypointNeRF(fast_preset(cfg, cull_budget=FAST_CULL_BUDGET), device=device)
    fast_model.load_state_dict(state)

    def render(model, sample):
        vb = ViewBatch.from_numpy(sample, device)
        out = render_image(model, vb, height=IMAGE, width=IMAGE, chunk=EVAL_CHUNK)
        img = np.clip(out["rgb_fine"].float().cpu().numpy(), 0.0, 1.0)
        ov = float(out["cull_overflow"].max()) if "cull_overflow" in out else 0.0
        return img, np.asarray(sample["tar_image"], np.float32), ov

    results = {}
    for split, base in (("seen", 0), ("unseen", UNSEEN_BASE)):
        ps, ss = [], []
        for seed in range(base, base + N_EVAL):
            img, gt, _ = render(eval_model, make_sample(scfg, seed=seed))
            ps.append(float(psnr(img, gt)))
            ss.append(float(structural_similarity(img, gt, multichannel=True)))
        results[split] = {"psnr": round(float(np.mean(ps)), 2),
                          "ssim": round(float(np.mean(ss)), 4)}
        print(json.dumps({"step": at_step, "split": split, **results[split]}), flush=True)
    for split, base in (("seen", 0), ("unseen", UNSEEN_BASE)):
        ps = []
        for seed in range(base, base + N_EVAL):
            img, gt, ov = render(fast_model, make_sample(scfg, seed=seed))
            if ov > 0:
                print(f"QUALITY GATE FAILED: empty-ray cull budget exceeded on {split} scene "
                      f"{seed} (overflow {ov:.0f} rays): the fast preset is unsound on the "
                      "gate scenes", file=sys.stderr)
                sys.exit(1)
            ps.append(float(psnr(img, gt)))
        r = results[split]
        r["fast_psnr"] = round(float(np.mean(ps)), 2)
        r["fast_delta_psnr"] = round(r["fast_psnr"] - r["psnr"], 2)
        print(json.dumps({"step": at_step, "split": split, "fast_psnr": r["fast_psnr"],
                          "fast_delta_psnr": r["fast_delta_psnr"]}), flush=True)
    return results


def load_thresholds(path):
    """The JSON dict at `path`, {} when there is no file."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def save_thresholds(path, th):
    with open(path, "w") as f:
        json.dump(th, f, indent=2)


def derive_floors(runs):
    """(floors, same-seed spread) from the runs at GATE_SEED without clip or
    warmup (all runs when there is none): each metric's least value less
    the larger of MARGINS and twice the pinned runs' spread."""
    pin = [r for r in runs if r.get("seed") == GATE_SEED
           and not r.get("clip") and not r.get("warmup")]
    if not pin:
        print(f"WARNING: no recorded run at the pinned gate seed {GATE_SEED}; floors derive "
              "from all runs", file=sys.stderr)
        pin = runs
    floors, spread = {}, {}
    for split in ("seen", "unseen"):
        floors[split], spread[split] = {}, {}
        for m, margin in MARGINS.items():
            vals = [r[split][m] for r in pin]
            spread[split][m] = round(max(vals) - min(vals), 4)
            floors[split][m] = round(min(vals) - max(margin, 2 * spread[split][m]), 4)
    return floors, spread


def main(argv=None) -> dict:
    """Run the gate; returns the final results ({"seen": ..., "unseen": ...}).
    Exits 1 on a cull overflow or, in assert mode, a floor broken."""
    args = create_parser().parse_args(argv)
    from .data import SyntheticConfig, make_sample
    from .device import resolve_device
    from .models import KeypointNeRF, ViewBatch
    from .training import LossConfig, OptimConfig, create_train_state, patch_pool

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = gate_config()
    model = KeypointNeRF(cfg, device=device, seed=args.seed)
    loss_cfg = LossConfig(lambda_vgg=0.0)      # deterministic gate: no random VGG
    optim = OptimConfig(learning_rate=args.lr, grad_clip=args.clip if args.clip > 0 else None,
                        warmup_steps=args.warmup)
    state = create_train_state(model, optim)
    scfg = SyntheticConfig(image_size=IMAGE, n_views=4)
    stack = stack_samples([make_sample(scfg, seed=i) for i in range(N_TRAIN)], device)
    pools = [patch_pool(ViewBatch(**{f: t[i] for f, t in stack.items()}))
             for i in range(N_TRAIN)]

    C = args.steps_chunk
    if args.eval_at:
        eval_points = sorted({-(-int(x) // C) * C for x in args.eval_at.split(",")})
        args.steps = eval_points[-1]
    else:
        # round up to a chunk multiple so the final eval fires
        args.steps = -(-args.steps // C) * C
        eval_points = [args.steps]

    trend, curve = [], []
    t0 = time.perf_counter()
    t_chunk = t0
    for done, last, gn_max, gn_at in train_gate(model, loss_cfg, state, stack, pools,
                                                args.seed, args.steps, C):
        now = time.perf_counter()
        curve.append(round(last, 6))
        if (done // C - 1) % 5 == 0 or args.log_every_chunk:
            print(f"step {done}/{args.steps} loss={last:.4f} gn_max={gn_max:.3e}@{gn_at} "
                  f"({now - t0:.0f}s, {(now - t_chunk) / C:.4f} s/step)", file=sys.stderr,
                  flush=True)
        t_chunk = now
        if done in eval_points:
            print(f"# eval at step {done} ({now - t0:.0f}s)", file=sys.stderr, flush=True)
            trend.append({"steps": done, **evaluate(model, scfg, device, done)})
            t_chunk = time.perf_counter()
    print(f"# trained {args.steps} steps in {time.perf_counter() - t0:.0f}s final loss "
          f"{curve[-1]:.4f}", file=sys.stderr)
    results = {k: trend[-1][k] for k in ("seen", "unseen")}

    if args.out_dir:
        from .utils import CheckpointManager, ExperimentConfig, save_config
        from .utils.config import DataConfig

        exp = ExperimentConfig(name="quality_gate", out_dir=args.out_dir, max_epochs=1,
                               model=cfg, loss=loss_cfg, optim=optim,
                               data=DataConfig(dataset="synthetic", image_size=IMAGE))
        run_dir = os.path.join(args.out_dir, exp.name)
        save_config(exp, run_dir)
        CheckpointManager(os.path.join(run_dir, "ckpts")).save(args.steps, state)
        print(f"# saved trained run -> {run_dir}", file=sys.stderr)

    protocol = {
        "steps": args.steps, "image": IMAGE, "patch": PATCH, "samples": SAMPLES,
        "n_train": N_TRAIN, "n_eval": N_EVAL,
        "recipe": "bf16 + per-map lookups + matmul VJP with K1 (no fused map), no remat, "
                  "lambda_vgg=0, the port's init and draws",
        "fast_preset": f"models/presets.py fast_preset with empty-cull budget "
                       f"{FAST_CULL_BUDGET}",
    }
    run = {"seed": args.seed, **{s: dict(r) for s, r in results.items()}, "loss": curve}
    if args.clip > 0:
        run["clip"] = args.clip
    if args.warmup > 0:
        run["warmup"] = args.warmup

    if args.write_trend:
        entry = {"seed": args.seed, "steps": args.steps, "points": trend}
        for k in ("clip", "warmup"):
            if k in run:
                entry[k] = run[k]
        th = load_thresholds(args.thresholds)
        th.setdefault("protocol", protocol)
        th.setdefault("trend_runs", []).append(entry)
        save_thresholds(args.thresholds, th)
        print(f"recorded trend ({len(trend)} checkpoint(s), seed {args.seed}) -> "
              f"{args.thresholds}")
        if not args.write_thresholds:
            return results

    if args.write_thresholds:
        th = load_thresholds(args.thresholds)
        runs = th.get("runs", []) + [run]
        floors, spread = derive_floors(runs)
        th.update(protocol=protocol, runs=runs, floors=floors, same_seed_spread=spread)
        if len({r["seed"] for r in runs}) > 1:
            th["cross_seed_spread"] = {
                split: {m: round(max(r[split][m] for r in runs)
                                 - min(r[split][m] for r in runs), 2)
                        for m in ("psnr", "fast_delta_psnr")}
                for split in ("seen", "unseen")}
        save_thresholds(args.thresholds, th)
        print(f"wrote thresholds ({len(runs)} run(s)) -> {args.thresholds}")
        return results

    th = load_thresholds(args.thresholds)
    if args.clip > 0 or args.warmup > 0:
        print("WARNING: asserting the clip- and warmup-free floors against a run with "
              f"--clip {args.clip} --warmup {args.warmup}", file=sys.stderr)
    if args.seed != GATE_SEED:
        print(f"WARNING: asserting floors at seed {args.seed}, but floors are pinned to seed "
              f"{GATE_SEED} runs", file=sys.stderr)
    if th["protocol"]["steps"] != args.steps:
        print(f"WARNING: thresholds were set at {th['protocol']['steps']} steps, this run "
              f"used {args.steps}", file=sys.stderr)
    failed = []
    for split, floors in th["floors"].items():
        for metric, floor in floors.items():
            got = results[split][metric]
            ok = got >= floor
            print(f"{split:7s} {metric}: {got} (floor {floor}) {'OK' if ok else 'REGRESSION'}")
            if not ok:
                failed.append((split, metric, got, floor))
    if failed:
        print("QUALITY GATE FAILED", file=sys.stderr)
        sys.exit(1)
    print("quality gate passed")
    return results


if __name__ == "__main__":
    main()
