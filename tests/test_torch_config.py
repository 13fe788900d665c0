"""Port parity for the config system (`keypointnerf_torch/utils/config.py`)
against `keypointnerf_tpu/utils/config.py`: the shipped configs field by
field (the compute dtype by name), dotted overrides, unknown keys, the
saved config, and the fast preset as configs/zju_fast.json ships it."""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from keypointnerf_tpu.utils import load_config as jax_load_config  # noqa: E402
from keypointnerf_torch.models import (  # noqa: E402
    FAST_CULL_BUDGET, KeypointNeRFConfig, fast_preset)
from keypointnerf_torch.utils import get_model, load_config, save_config  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = [os.path.join(ROOT, "configs", n) for n in ("zju.json", "zju_fast.json",
                                                       "synthetic.json")]


def _fields(cfg):
    """{dotted name: value} of an ExperimentConfig, the dtype by name."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x for k, x in _fields(v).items()})
        elif f.name == "compute_dtype":
            out[f.name] = (str(v).replace("torch.", "") if isinstance(v, torch.dtype)
                           else jnp.dtype(v).name)
        else:
            out[f.name] = v
    return out


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_shipped_configs_match_jax(path):
    """Every field of every section equals JAX's, with the same names."""
    ours, ref = _fields(load_config(path)), _fields(jax_load_config(path))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k] == ref[k], k


def test_dotted_overrides():
    overrides = {"optim.learning_rate": 2e-4, "model.patch_h": 32, "model.compute_dtype": "f32",
                 "data.image_size": 64, "name": "exp", "loss.top_losses": [["l1", 25, 1.0]]}
    cfg = load_config(os.path.join(ROOT, "configs", "zju.json"), overrides=overrides)
    assert cfg.optim.learning_rate == 2e-4 and cfg.model.patch_h == 32
    assert cfg.model.compute_dtype == torch.float32 and cfg.data.image_size == 64
    assert cfg.name == "exp" and cfg.loss.top_losses == (("l1", 25, 1.0),)
    assert cfg.model.n_coarse == 64                     # the file's value stays
    assert _fields(cfg) == _fields(jax_load_config(os.path.join(ROOT, "configs", "zju.json"),
                                                   overrides=overrides))
    assert load_config(None).model == KeypointNeRFConfig()


@pytest.mark.parametrize("bad", [{"model": {"n_coarse_typo": 1}}, {"nmae": "x"},
                                 {"optim": {"lr": 1e-3}}])
def test_unknown_keys_rejected(tmp_path, bad):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(bad))
    with pytest.raises(KeyError, match="unknown config key"):
        load_config(str(p))
    with pytest.raises(KeyError):
        jax_load_config(str(p))
    with pytest.raises(ValueError, match="compute_dtype"):
        load_config(None, overrides={"model.compute_dtype": "fp16"})


def test_save_config_round_trip(tmp_path):
    """save_config stamps the git HEAD and writes a file that loads back to
    the same config (the stamp taken out)."""
    cfg = load_config(os.path.join(ROOT, "configs", "zju_fast.json"),
                      overrides={"model.n_fine": 32})
    path = save_config(cfg, str(tmp_path / "run"))
    d = json.loads(open(path).read())
    assert d.pop("__git_head__")
    assert d["model"]["compute_dtype"] == "bfloat16"
    again = tmp_path / "again.json"
    again.write_text(json.dumps(d))
    assert load_config(str(again)) == cfg


def test_zju_fast_config_is_fast_preset():
    """configs/zju_fast.json's model block is the fast preset on the default
    (zju) architecture (JAX tests/test_presets.py:26)."""
    cfg = load_config(os.path.join(ROOT, "configs", "zju_fast.json"))
    assert cfg.purpose == "eval"
    assert cfg.model == fast_preset()
    assert cfg.model.cull_empty_rays_ratio == FAST_CULL_BUDGET == 0.25
    assert cfg.model.fine_topk_ratio == 0.75 and cfg.model.coarse_topk_ratio == 1.0


def test_fast_preset_forces_training_flags_off():
    """The preset is an eval program: a training base's flags do not leak
    into it (JAX tests/test_presets.py:69); its other fields are JAX's."""
    from keypointnerf_tpu.models import KeypointNeRFConfig as JaxConfig
    from keypointnerf_tpu.models import fast_preset as jax_fast

    flags = dict(remat=True, remat_save_gathers=True, train_matmul_gather_vjp=True,
                 train_pallas_dmap=True)
    preset = fast_preset(dataclasses.replace(KeypointNeRFConfig(), **flags))
    assert not any(getattr(preset, k) for k in flags)
    ref = jax_fast(dataclasses.replace(JaxConfig(), **flags))
    for f in dataclasses.fields(preset):
        a, b = getattr(preset, f.name), getattr(ref, f.name)
        if f.name == "compute_dtype":
            assert a == torch.bfloat16 and jnp.dtype(b).name == "bfloat16"
        else:
            assert a == b, f.name


def test_get_model_builds_the_config():
    cfg = load_config(os.path.join(ROOT, "configs", "zju_fast.json"), overrides={
        "model.n_coarse": 4, "model.n_fine": 4, "model.geo_n_downsample": 2})
    model = get_model(cfg, device="cpu")
    assert model.cfg == cfg.model and model.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            get_model(cfg)
