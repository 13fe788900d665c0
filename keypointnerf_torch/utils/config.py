"""Config system: JSON (or YAML) experiment configs -> typed dataclasses.

Port of `keypointnerf_tpu/utils/config.py`. The configs under `configs/`
are nested dicts: top-level experiment fields plus "model", "loss",
"optim" and "data" sections, which build the port's
`KeypointNeRFConfig`, `LossConfig`, `OptimConfig` and `DataConfig`.
Unknown keys are rejected, so a typo fails loudly. `"compute_dtype"` is
read as "bf16" / "bfloat16" / "f32" / "float32".
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from typing import Any, Dict, Optional

import torch

from ..device import DeviceLike
from ..models.keypoint_nerf import KeypointNeRFConfig
from ..training.losses import LossConfig
from ..training.train import OptimConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"        # "synthetic" | "zju"
    data_root: str = ""
    image_size: int = 512             # after the 0.5x ratio
    image_ratio: float = 0.5
    n_source_views: int = 3
    max_len_val: int = 2
    sample_frame: int = 30            # test subsampling
    num_workers: int = 0              # loader threads; 0 loads inline
    batch_per_device: int = 1         # samples per device per optimizer step


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "keypointnerf"
    out_dir: str = "out"
    # "train" or "eval": eval presets (configs/zju_fast.json) carry
    # inference-only model flags
    purpose: str = "train"
    seed: int = 125
    max_epochs: int = 30
    val_every_steps: int = 500
    ckpt_every_steps: int = 1000
    log_every_steps: int = 50
    vgg_weights: str = ""             # optional torchvision vgg19 .pth
    model: KeypointNeRFConfig = dataclasses.field(default_factory=KeypointNeRFConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)


_DTYPES = {
    "float32": torch.float32, "f32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}

_SUB = {
    "model": KeypointNeRFConfig,
    "loss": LossConfig,
    "optim": OptimConfig,
    "data": DataConfig,
}


def _build(cls, d: Dict[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        if isinstance(v, dict) and k in _SUB:
            kwargs[k] = _build(_SUB[k], v)
        elif k == "compute_dtype" and isinstance(v, str):
            if v not in _DTYPES:
                raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {v!r}")
            kwargs[k] = _DTYPES[v]
        elif isinstance(v, list):
            kwargs[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def load_config(path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> ExperimentConfig:
    """An ExperimentConfig from a JSON (or, when PyYAML is installed, YAML)
    file plus overrides with dotted keys: {"optim.learning_rate": 1e-3}."""
    d: Dict[str, Any] = {}
    if path:
        with open(path) as f:
            if path.endswith((".yml", ".yaml")):
                try:
                    import yaml
                except ImportError as e:
                    raise ImportError(
                        f"{path}: reading a YAML config needs PyYAML, which is not "
                        "installed; the shipped configs are JSON") from e
                d = yaml.safe_load(f)
            else:
                d = json.load(f)
    d.pop("__git_head__", None)       # what save_config adds: a run's config loads back
    for k, v in (overrides or {}).items():
        parts = k.split(".")
        cur = d
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return _build(ExperimentConfig, d)


def git_head_hash() -> str:
    """The git HEAD of the checkout this package lies in, or "unknown"."""
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        return "unknown"


def save_config(cfg: ExperimentConfig, out_dir: str) -> str:
    """Write the merged config and the git HEAD to `out_dir`/config.json.
    The dtype is written by name ("bfloat16" / "float32"), which
    `load_config` reads back."""
    os.makedirs(out_dir, exist_ok=True)
    d = dataclasses.asdict(cfg)
    d["__git_head__"] = git_head_hash()
    d["model"]["compute_dtype"] = str(d["model"]["compute_dtype"]).replace("torch.", "")
    path = os.path.join(out_dir, "config.json")
    with open(path, "w") as f:
        json.dump(d, f, indent=2, default=str)
    return path


def get_model(cfg: ExperimentConfig, device: DeviceLike = None):
    """The port's KeypointNeRF of `cfg.model`, on the card unless `device`
    names another."""
    from ..models import KeypointNeRF

    return KeypointNeRF(cfg.model, device=device)
