"""The reference-checkpoint import (`keypointnerf_torch/utils/
import_reference.py`) against the JAX package's importer.

A seeded toy port model writes a fake reference Lightning `.ckpt` (its
tensors under `model.`, frozen `vgg_loss.*` tensors under the prefix and
outside it, Lightning's other keys) and a bare `.pth` state_dict. The
port's import must give, bit for bit, what the JAX package's
`load_reference_checkpoint` followed by `state_dict_from_jax` gives (no
JAX program is compiled: the importer converts arrays). A missing or an
extra model key raises; `vgg_loss.*` is ignored.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from keypointnerf_tpu.models import KeypointNeRFConfig as JaxConfig  # noqa: E402
from keypointnerf_tpu.utils.import_torch import load_reference_checkpoint as jax_load  # noqa: E402
from keypointnerf_torch import models as tm  # noqa: E402
from keypointnerf_torch.utils import (  # noqa: E402
    load_reference_checkpoint,
    reference_state_dict,
    state_dict_from_jax,
)

TINY = dict(n_coarse=4, n_fine=4, patch_h=4, patch_w=4, geo_n_downsample=2)


def _vgg(rs):
    return {"vgg.features.0.weight": torch.from_numpy(rs.normal(size=(4, 3, 3, 3)).astype(
        np.float32)), "vgg.features.0.bias": torch.zeros(4)}


@pytest.fixture(scope="module")
def source():
    return tm.KeypointNeRF(tm.KeypointNeRFConfig(**TINY), device="cpu", seed=3)


def write_ckpt(path, source, drop=None, extra=None):
    rs = np.random.default_rng(0)
    sd = {f"model.{k}": v for k, v in source.state_dict().items() if k != drop}
    sd.update({f"model.vgg_loss.{k}": v for k, v in _vgg(rs).items()})
    sd.update({f"vgg_loss.{k}": v for k, v in _vgg(rs).items()})
    sd.update(extra or {})
    torch.save({"state_dict": sd, "epoch": 7, "global_step": 1234,
                "pytorch-lightning_version": "1.5.10", "optimizer_states": [{"state": {}}],
                "lr_schedulers": [], "hyper_parameters": {"lr": 5e-4}}, path)
    return path


def _held_against_jax(path):
    """The port's import of `path` equals JAX's importer + state_dict_from_jax."""
    model = load_reference_checkpoint(path, tm.KeypointNeRF(tm.KeypointNeRFConfig(**TINY),
                                                            device="cpu", seed=9))
    ref = state_dict_from_jax(jax.tree.map(np.asarray, jax_load(str(path), JaxConfig(**TINY))),
                              tm.KeypointNeRFConfig(**TINY))
    got = model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    return got


def test_lightning_ckpt_matches_jax_importer(source, tmp_path):
    got = _held_against_jax(write_ckpt(tmp_path / "last.ckpt", source))
    for k, v in source.state_dict().items():
        assert torch.equal(got[k], v), k


def test_bare_pth_matches_jax_importer(source, tmp_path):
    path = tmp_path / "model.pth"
    sd = dict(source.state_dict(), **{f"vgg_loss.{k}": v
                                      for k, v in _vgg(np.random.default_rng(1)).items()})
    torch.save(sd, path)
    got = _held_against_jax(path)
    assert all(torch.equal(got[k], v) for k, v in source.state_dict().items())
    assert not any(k.startswith("vgg_loss") for k in reference_state_dict(str(path)))


def test_missing_or_extra_model_key_raises(source, tmp_path):
    missing = write_ckpt(tmp_path / "missing.ckpt", source, drop="ibr_compress_gfeat.bias")
    extra = write_ckpt(tmp_path / "extra.ckpt", source,
                       extra={"model.mlp_tex.unknown.weight": torch.zeros(2)})
    for path, word in ((missing, "Missing"), (extra, "Unexpected")):
        with pytest.raises(RuntimeError, match=word):
            load_reference_checkpoint(str(path), tm.KeypointNeRF(tm.KeypointNeRFConfig(**TINY),
                                                                  device="cpu"))
