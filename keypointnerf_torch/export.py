"""Model export for serving: a `torch.export` program of the render.

Port of `keypointnerf_tpu/export.py`. The JAX package serializes the
jitted render as StableHLO; the port serializes it as a `torch.export`
program (`torch.export.save` bytes). The program holds the render's aten
graph, the port's kernels as registered ops (`torch.ops.kpnerf.*`: K2,
K3, K4, K5, K6; `ops/`), and no weights: the weights are its first input,
so one artifact serves any checkpoint of its config.

Exported signature (flat tensors and one dict of them):

    serve(params, src_images, src_masks, src_K, src_R, src_t,
          kpt3d, bounds, tar_K, R, t) -> ((H, W, 3) rgb, cull_overflow)

`params` is the port's `state_dict` (any key order). Shapes and dtypes
are fixed at export: the loaded program raises on any other.

The second output is the exact empty-ray cull's runtime soundness guard
(render/renderer.py): 0.0 means every rendered ray outside the baked
`cull_empty_rays_ratio` budget was PROVABLY empty, i.e. the frame equals
the uncalled render bit-for-bit; nonzero means the scene's visual hull
exceeded the baked budget and that many subject rays were silently
zeroed — the serving contract is that callers MUST check it (or bake a
budget sized with `render.suggest_cull_budget` / export with culling
off). It is a constant 0.0 when the model config does not cull. The
serve path is exactly where unsized scenes appear, so the guard ships
inside the artifact rather than as a host-side wrapper (docs/API.md
"Serving contract").

A consumer needs torch and the op registrations alone: `load_render`
imports `keypointnerf_torch.ops` (which registers the `kpnerf::` ops and
builds a kernel at its first launch), never the model. An artifact runs
on the device type it was exported for (`device`, the counterpart of
JAX's `platforms`). The render's chunk loop and the cull's score loop
are unrolled in the program, where JAX keeps a `lax.map` / `lax.scan`.

Source-view encoding runs inside the program; for many-camera orbits of
the same subject prefer `render.video.render_orbit` (encode-once) — the
export trades that caching for a self-contained single-call artifact.
"""
from __future__ import annotations

import copy
import io
from typing import Dict

import torch

from . import ops  # noqa: F401  (registers the kpnerf:: ops a program calls)


class _Bound(torch.nn.Module):
    """`fn(model, *args)` as a module's forward, so that
    `torch.func.functional_call` can run it on given parameters."""

    def __init__(self, model, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _with_params(model, fn):
    """serve(params, *args) = fn(model, *args) with the model's parameters
    replaced by `params` (the model's state_dict keys). A tensor the model
    registers under two names (a ConvBlock's `bn4` is also `downsample.0`)
    is taken from its first name and tied to the other. The function runs
    a copy of the model: functional_call does not put such a tensor back
    (torch 2.11-2.13), and a trace would leave its fake in the caller's
    model."""
    bound = _Bound(copy.deepcopy(model), fn)
    names = [k for k, _ in model.named_parameters()] + [k for k, _ in model.named_buffers()]

    def serve(params: Dict[str, torch.Tensor], *args):
        named = {f"model.{k}": params[k] for k in names}
        return torch.func.functional_call(bound, named, args, strict=True)

    return serve


def _view_batch(src_images, src_masks, src_K, src_R, src_t, kpt3d, bounds, tar_K, R, t):
    from .models.keypoint_nerf import ViewBatch

    # target image / mask are training-only; the render never reads them
    return ViewBatch(
        src_images=src_images, src_masks=src_masks, src_K=src_K, src_R=src_R, src_t=src_t,
        tar_image=src_images.new_zeros((1, 1, 3)), tar_mask=src_masks.new_zeros((1, 1, 1)),
        tar_K=tar_K, tar_R=R, tar_t=t, kpt3d=kpt3d, bounds=bounds)


def make_serving_fn(model, height: int, width: int, chunk: int = 4096):
    """A self-contained (params, views, camera) -> (rgb, cull_overflow) fn.

    See the module docstring for the overflow output's serving contract.
    """
    from .geometry.cameras import camera_rays, pixel_grid
    from .render.renderer import render_rays_chunked

    cfg = model.cfg

    def render(m, src_images, src_masks, src_K, src_R, src_t, kpt3d, bounds, tar_K, R, t):
        vb = _view_batch(src_images, src_masks, src_K, src_R, src_t, kpt3d, bounds,
                         tar_K, R, t)
        with torch.no_grad():
            feats = m.encode(src_images, src_masks)
            pix = pixel_grid(height, width, device=tar_K.device).float()
            origin, dirs, near, far = camera_rays(pix, tar_K, R, t, cfg.znear, cfg.zfar)
            out = render_rays_chunked(m, feats, vb, origin, dirs, near, far, chunk=chunk)
            overflow = out["cull_overflow"].max() if "cull_overflow" in out \
                else torch.zeros((), device=tar_K.device)
        return out["rgb_fine"].reshape(height, width, 3), overflow

    return _with_params(model, render)


def make_multicam_serving_fn(model, height: int, width: int, chunk: int = 4096):
    """A (params, views, F-camera stacks) -> ((F, H, W, 3), overflow) fn.

    The video/orbit serving shape: source views are encoded ONCE inside
    the program, then every target camera is marched
    (render_cameras_scanned) — the artifact keeps the reference's
    attach_im_feat amortization (src/model.py:642-688) without any Python
    caller managing a feature cache. Camera args are stacks:
    tar_K/R (F, 3, 3), t (F, 3). The second output is the max
    cull-overflow across all F cameras (module docstring: a deployed
    culled preset renders cameras its budget was never sized for — any
    orbit camera overflowing the budget must be detectable from the
    artifact's outputs alone).
    """
    from .render.renderer import render_cameras_scanned

    def render(m, src_images, src_masks, src_K, src_R, src_t, kpt3d, bounds, tar_Ks, Rs, ts):
        vb = _view_batch(src_images, src_masks, src_K, src_R, src_t, kpt3d, bounds,
                         tar_Ks[0], Rs[0], ts[0])
        with torch.no_grad():
            feats = m.encode(src_images, src_masks)
            return render_cameras_scanned(m, feats, vb, tar_Ks, Rs, ts, height=height,
                                          width=width, chunk=chunk)

    return _with_params(model, render)


class _Serve(torch.nn.Module):
    """The serving function as the module `torch.export` takes; it
    registers neither the model nor its weights."""

    def __init__(self, serve):
        super().__init__()
        self.serve = serve

    def forward(self, params, *args):
        return self.serve(params, *args)


def export_render(
    model,
    params,
    example_args,
    *,
    height: int,
    width: int,
    chunk: int = 4096,
    device=None,
    multicam: bool = False,
) -> bytes:
    """Serialize the serving function to `torch.export.save` bytes.

    `params` is the model's state_dict (its shapes and dtypes are baked
    in, not its values); `example_args` the flat tuple (src_images,
    src_masks, src_K, src_R, src_t, kpt3d, bounds, tar_K, R, t), of which
    only shapes and dtypes are captured. `device` (CUDA unless named) is
    where the program runs: an artifact runs on the device type it was
    exported for, the kernels' CUDA ops on the card and their plain
    versions on the CPU. With `multicam=True` the camera entries are (F,
    ...) stacks and the artifact returns ((F, H, W, 3), overflow);
    single-camera artifacts return ((H, W, 3), overflow). Callers must
    check the overflow guard (module docstring).
    """
    from .device import resolve_device

    dev = resolve_device(device)
    serve = (make_multicam_serving_fn if multicam else make_serving_fn)(
        model, height, width, chunk)
    # fresh tensors of the params' shapes, one per key (the state_dict
    # names a shared tensor twice), in key order (`load_render` sorts)
    spec_params = {k: torch.empty_like(params[k], device=dev) for k in sorted(params)}
    spec_args = tuple(torch.as_tensor(a).to(dev) for a in example_args)
    with torch.no_grad():
        exported = torch.export.export(_Serve(serve), (spec_params, *spec_args), strict=False)
    exported.example_inputs = None        # the artifact holds no weights
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_render(data: bytes):
    """Deserialize an exported render program into a callable.

    The callable takes the same (params, *flat_args) as the exported
    function, on the device it was exported for; it needs only the op
    registrations (`keypointnerf_torch.ops`), never the model.
    """
    program = torch.export.load(io.BytesIO(data)).module()

    def call(params, *args):
        return program({k: params[k] for k in sorted(params)}, *args)

    call.program = program            # the loaded graph module, for inspection
    return call
