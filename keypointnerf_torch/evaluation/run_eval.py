"""Test-set evaluation: full-image renders and mean metrics.

Port of `keypointnerf_tpu/evaluation/run_eval.py`: render each test
sample at full resolution with the port's `render_image`, score PSNR /
SSIM with the `Evaluator` (which saves the pred / gt / input PNG trees)
and write the means to `{out_dir}/{name}/test_v3_{step}.yml`. In a
torch.distributed group rank 0 alone scores and writes: with `sharded`
every rank renders its share of each image's rays
(`parallel.make_sharded_render`), else rank 0 renders alone.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..models.keypoint_nerf import KeypointNeRF, ViewBatch
from ..parallel import default_group, make_sharded_render, rank, world_size
from ..render import render_image, suggest_cull_budget
from .evaluator import Evaluator


def run_eval(
    cfg,
    model: KeypointNeRF,
    dataset,
    result_dir: Optional[str] = None,
    max_samples: Optional[int] = None,
    stride: int = 1,
    sharded: bool = False,
    auto_cull_budget: int = 0,
    step: int = 0,
    group=None,
) -> Dict[str, float]:
    """Mean {"mse", "psnr", "ssim"} of `model` over `dataset` (numpy sample
    dicts, each with an optional "meta" dict; None entries are skipped).

    `cfg` is the ExperimentConfig (out_dir / name place the outputs);
    `step` names the YAML file. `auto_cull_budget=N`, with a culling model,
    scores the first N loadable samples' target cameras with
    `suggest_cull_budget` and raises the cull budget to cover them. A
    rendered sample whose `cull_overflow` is nonzero is reported.
    `group` is the torch.distributed group (default: the default group once
    one is initialized). `sharded=True` splits each image's rays over its
    ranks; with one rank it is the unsharded render, as in JAX. Ranks other
    than 0 return {}.
    """
    group = default_group() if group is None else group
    world = 1 if group is None else world_size(group)
    main = world == 1 or rank(group) == 0
    if not (main or sharded):
        return {}
    sharded_render = None
    if sharded and world > 1:
        if stride != 1:
            raise ValueError("sharded evaluation renders at full resolution (stride 1)")
        sharded_render = make_sharded_render(model, group)
    out_dir = os.path.join(cfg.out_dir, cfg.name)
    result_dir = result_dir or os.path.join(out_dir, "images_v3")
    evaluator = Evaluator(result_dir=result_dir) if main else None
    dev = model.device

    if auto_cull_budget and model.cfg.cull_empty_rays_ratio < 1.0:
        worst_budget, worst_hull, probed = 0.0, 0.0, 0
        for i in range(len(dataset)):
            if probed >= auto_cull_budget:
                break
            sample = dataset[i]
            if sample is None:
                continue
            vb = ViewBatch.from_numpy(sample, dev)
            H, W = vb.tar_image.shape[:2]
            feats = (model.encode(vb.src_images, vb.src_masks)
                     if model.cfg.fused_feature_map else None)
            b, h = suggest_cull_budget(model.cfg, vb, [(vb.tar_K, vb.tar_R, vb.tar_t)],
                                       H, W, feats=feats)
            worst_budget, worst_hull = max(worst_budget, b), max(worst_hull, h)
            probed += 1
        if worst_budget > model.cfg.cull_empty_rays_ratio:
            print(f"auto_cull_budget: raising cull budget "
                  f"{model.cfg.cull_empty_rays_ratio} -> {worst_budget} "
                  f"(probed {probed} samples, worst hull {worst_hull:.3f})")
            model = model.with_config(cull_empty_rays_ratio=worst_budget)
            if sharded_render is not None:
                sharded_render = make_sharded_render(model, group)

    scores = []
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    for i in range(n):
        sample = dataset[i]
        if sample is None:
            continue
        meta = sample.get("meta", {})
        vb = ViewBatch.from_numpy(sample, dev)
        H, W = vb.tar_image.shape[:2]
        if sharded_render is not None:
            out = sharded_render(vb, height=H, width=W)
        else:
            out = render_image(model, vb, height=H, width=W, stride=stride)
        if not main:
            continue
        if "cull_overflow" in out:
            ov = float(out["cull_overflow"].max())
            if ov > 0:
                print(f"WARNING: sample {i}: empty-ray cull budget exceeded by {ov:.0f} "
                      "rays — this image is NOT exact; raise cull_empty_rays_ratio or use "
                      "auto_cull_budget")
        pred = np.clip(out["rgb_fine"].float().cpu().numpy(), 0.0, 1.0)
        gt = np.asarray(sample["tar_image"])[::stride, ::stride]
        mab = np.asarray(meta.get("mask_at_box", np.ones((H, W))))[::stride, ::stride]
        score = evaluator.compute_score(
            pred, gt, mab,
            input_imgs=np.asarray(sample["src_images"]),
            human_idx=str(meta.get("human", "h")),
            frame_index=int(meta.get("frame_index", i)),
            view_index=int(meta.get("tar_cam_id", 0)),
        )
        scores.append(score)
        print(f"[{i + 1}/{n}] psnr={score['psnr']:.2f} ssim={score['ssim']:.4f}")

    if not main:
        return {}
    mean = {k: float(np.mean([s[k] for s in scores])) for k in scores[0]} if scores else {}
    yml_path = os.path.join(out_dir, f"test_v3_{step}.yml")
    os.makedirs(out_dir, exist_ok=True)
    with open(yml_path, "w") as f:
        for k, v in mean.items():
            f.write(f"{k}: {v}\n")
    print("mean:", mean, "->", yml_path)
    return mean
