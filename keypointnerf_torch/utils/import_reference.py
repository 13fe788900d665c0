"""Import reference KeypointNeRF checkpoints into the port.

The counterpart of `keypointnerf_tpu/utils/import_torch.py:
load_reference_checkpoint` (docs/MIGRATION.md "Checkpoints"). The
reference trains a torch `KeypointNeRF` inside a LightningModule whose
checkpoint stores `state_dict` with a `model.` prefix (reference
src/model.py:42, 113-117). The port's modules keep the reference's
state_dict layout, so the import is a load: no tensor is converted.

  * A Lightning `.ckpt` ({"state_dict": ..., "epoch": ..., ...}) or a bare
    `.pth` state_dict, read with `torch.load(..., weights_only=False)` as
    the JAX importer reads it (a Lightning checkpoint pickles more than
    tensors: load only files you trust).
  * Keys under the `model.` prefix (when any key has it; else every key)
    are the model's, the prefix stripped; the frozen `vgg_loss.*` tensors
    are left out; keys outside the prefix are the LightningModule's own.
  * `load_state_dict(strict=True)`: a missing or an extra model key raises.
"""
from __future__ import annotations

from typing import Dict

import torch

PREFIX = "model."


def reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The model's tensors of a reference checkpoint, keyed as the port's
    state_dict (`model.` stripped, `vgg_loss.*` left out)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    prefix = PREFIX if any(k.startswith(PREFIX) for k in sd) else ""
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and not k[len(prefix):].startswith("vgg_loss")}


def load_reference_checkpoint(path: str, model):
    """Load a reference Lightning .ckpt (or bare .pth state_dict) into
    `model` (a `KeypointNeRF` of the checkpoint's architecture, on any
    device), strictly. Returns the model."""
    model.load_state_dict(reference_state_dict(path), strict=True)
    return model
