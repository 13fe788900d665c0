"""separate_cf's 3-output path against the 2-output union render (CPU, f32,
toy widths): a separate_cf model whose rad_f row of the last geometry layer
is a copy of rad_c's renders exactly what the 2-output model renders with
`reuse_coarse_eval=False` (both fine passes evaluate the 128-depth union
of a ray's coarse and fine depths), with `use_pallas_geo_mlp` off (the
modules) and on (K5's plain version at 3 outputs, what the kernel is held
against on the card). chip_smoke.py's model_rest phase renders the same
pair at full width on the card with the kernel; the tied model comes from
its `tied_separate_cf`.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one share of the cores a process)

from keypointnerf_torch.data import SyntheticConfig, make_sample  # noqa: E402
from keypointnerf_torch.models import KeypointNeRF, KeypointNeRFConfig, ViewBatch  # noqa: E402
from keypointnerf_torch.render import render_image  # noqa: E402

from chip_smoke import tied_separate_cf  # noqa: E402


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "k5_plain"])
def test_tied_separate_cf_renders_the_union(fused):
    cfg = KeypointNeRFConfig(n_coarse=8, n_fine=8, geo_n_downsample=2, tex_ngf=16,
                             compute_dtype=torch.float32, reuse_coarse_eval=False,
                             use_pallas_geo_mlp=fused)
    model = KeypointNeRF(cfg, device="cpu", seed=0)
    with torch.no_grad():
        model.mlp_geo.layers2.layers[-1].linear.bias[1:] += 1.5   # radiance > 0 somewhere
    vb = ViewBatch.from_numpy(make_sample(SyntheticConfig(image_size=32), seed=0), "cpu")
    tied = tied_separate_cf(model, cfg)
    kw = dict(height=32, width=32, chunk=1024)
    two, three = render_image(model, vb, **kw), render_image(tied, vb, **kw)
    assert float(two["acc_fine"].max()) > 0.1
    assert two.keys() == three.keys()
    for k in two:
        assert torch.equal(two[k], three[k]), k
