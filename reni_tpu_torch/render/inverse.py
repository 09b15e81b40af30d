"""FIT_INVERSE wiring (the port's counterpart of ``reni_tpu/render/inverse.py``):
scene set-up, ground-truth renders, the step builder.

The reference's inverse-rendering flow (src/lightning/RENI_module.py: 64-73
on_fit_start, 363-384 generate_gt_renders, 107-112 training_step): the mesh
and camera are static, so rasterization happens once on the host (the C++
rasterizer of ``render/rasterizer.py``); ground-truth renders of every test
environment map are made once on the device; each training step decodes env
maps from the latents, unnormalises them, renders them with the
differentiable Blinn-Phong shader and descends the render loss into the
latent codes.
"""

from __future__ import annotations

from typing import Callable

import torch

from reni_tpu_torch.core import sphere
from reni_tpu_torch.models.reni import RENIModel
from reni_tpu_torch.render import mesh as mesh_lib
from reni_tpu_torch.render import shading
from reni_tpu_torch.render.rasterizer import rasterize_world
from reni_tpu_torch.train import tasks
from reni_tpu_torch.utils.device import resolve_device
from reni_tpu_torch.utils.profiling import backward_span, span


class InverseRenderSetup:
    """Static scene of the inverse task on ``device`` (default: the card);
    builds the pieces of each environment-map resolution.

    ``azimuths`` / ``elevations`` add static camera views: the GT and
    predicted renders of all views are concatenated along the image-height
    axis, so every loss (the reference's cosine over the pixel axis
    included) applies unchanged; one view at azim = elev = 0 is the
    reference's single look_at_view_transform(dist, 0, 0) camera
    (pytorch3d_envmap_shader.py:195-217)."""

    def __init__(
        self,
        obj_path_or_mesh,
        *,
        render_resolution: int = 128,
        kd: float = 0.5,
        obj_rotation: float = 0.0,
        camera_distance: float = 2.0,
        shininess: float = 500.0,
        backend: str = "native",
        light_chunk: int | None = None,
        azimuths: tuple[float, ...] = (0.0,),
        elevations: tuple[float, ...] | None = None,
        device=None,
    ):
        if isinstance(obj_path_or_mesh, mesh_lib.Mesh):
            m = obj_path_or_mesh
        else:
            m = mesh_lib.load_obj(obj_path_or_mesh)
        if obj_rotation:
            m = mesh_lib.Mesh(mesh_lib.rotate_y(m.verts, obj_rotation), m.faces)
        self.mesh = m
        self.render_resolution = render_resolution
        self.kd = kd
        self.device = resolve_device(device)
        azimuths = tuple(azimuths)
        if elevations is None:
            elevations = (0.0,) * len(azimuths)
        elevations = tuple(elevations)
        if len(elevations) == 1 and len(azimuths) > 1:
            elevations = elevations * len(azimuths)
        if len(elevations) != len(azimuths):
            raise ValueError(
                f"AZIMUTHS ({len(azimuths)}) and ELEVATIONS "
                f"({len(elevations)}) must pair up"
            )
        self.azimuths, self.elevations = azimuths, elevations

        vn = mesh_lib.vertex_normals(m)
        self.fragments = None  # the first view's
        self._renders = []
        for azim, elev in zip(azimuths, elevations):
            fragments, eye = rasterize_world(
                m, render_resolution, dist=camera_distance, elev=elev, azim=azim,
                backend=backend,
            )
            if self.fragments is None:
                self.fragments = fragments
            self._renders.append(shading.make_render_fn(
                fragments, m.face_verts, vn[m.faces], eye, kd=kd, shininess=shininess,
                chunk=light_chunk, device=self.device,
            ))

    def render_fn(self, width: int) -> Callable:
        """render(envmaps (B, P, 3) unnormalised, sineweight (B, P, 3),
        rows=None) -> (B, V*H, W, 3) for env maps of equirect width
        ``width``: the V static views stacked along the height axis (V = 1:
        plain (B, H, W, 3)); with ``rows`` (a slice of V*H, a mesh rank's)
        only those rows, each view rendering its part of them (each view's
        transport product, ``shading.make_render_fn``). Spans
        (``utils/profiling.py``): ``render.forward``, inside it a view's
        ``render.transport`` or ``render.chunked``, and ``render.backward``
        from the render's output back to ``envmaps``."""
        light_dirs = sphere.get_directions(width, device=self.device)[0]
        h = self.render_resolution

        def render(envmaps, sineweight, rows: slice = slice(None)):
            with span("render.forward", envmaps):
                envmaps, close = backward_span("render.backward", envmaps)
                lo, hi, _ = rows.indices(h * len(self._renders))
                views = [r(envmaps, sineweight, light_dirs,
                           slice(max(lo - v * h, 0), min(hi - v * h, h)))
                         for v, r in enumerate(self._renders)
                         if lo < (v + 1) * h and hi > v * h]
                return close(views[0] if len(views) == 1 else torch.cat(views, dim=1))

        return render

    def generate_gt_renders(
        self, images: torch.Tensor, unnormalise: Callable, width: int, batch: int = 4
    ) -> torch.Tensor:
        """GT renders of (S, P, 3) normalised env maps, ``batch`` maps a call
        (RENI_module.py:363-384); no gradient."""
        render = self.render_fn(width)
        # float32, as the JAX package builds it, then the maps' dtype
        sw = sphere.get_sineweight(width, device=images.device).to(images.dtype)
        outs = []
        with torch.no_grad():
            for i in range(0, images.shape[0], batch):
                chunk = unnormalise(images[i : i + batch])
                outs.append(render(chunk, sw.expand(chunk.shape)))
        return torch.cat(outs, dim=0)


def fit_inverse(
    model: RENIModel,
    params,
    task_cfg: tasks.TaskConfig,
    dataset_images_at: Callable,
    unnormalise: Callable,
    generator: torch.Generator,
    *,
    setup: InverseRenderSetup | None = None,
    wrap_step: Callable | None = None,
    **fit_kw,
):
    """The whole FIT_INVERSE task: ``tasks.fit_task`` with the render loss.

    ``dataset_images_at(res)`` -> (S, H*W, 3) normalised maps on the training
    device; their GT renders are made once per resolution. Without a
    ``setup`` the scene comes from ``task_cfg`` (OBJECT_PATH,
    RENDER_RESOLUTION, KD_VALUE, AZIMUTHS, ELEVATIONS) on the device of the
    latents. ``wrap_step(step, res)`` may wrap each stage's step (timing,
    counting); the other keywords go to ``fit_task``. With ``mesh=`` the
    task runs data-sharded: each rank decodes the whole light set of its
    rows of the batch and renders, where the render's rows divide the pixel
    axis, its slice of them (``fit_task`` shards the targets' axis 1); on a
    model axis the frozen decoder is sharded too, and the decodes run
    through ``parallel/tp.py``."""
    if setup is None:
        setup = InverseRenderSetup(
            task_cfg.object_path,
            render_resolution=task_cfg.render_resolution,
            kd=task_cfg.kd_value,
            azimuths=task_cfg.azimuths,
            elevations=task_cfg.elevations,
            device=model.latents(params).device,
        )

    gt_cache: dict[tuple[int, int], torch.Tensor] = {}

    def gt_at(res):
        res = tuple(res)
        if res not in gt_cache:
            gt_cache[res] = setup.generate_gt_renders(dataset_images_at(res), unnormalise, res[1])
        return gt_cache[res]

    def build(model_, directions, sineweight, res):
        step = tasks.make_fit_inverse_step(
            model_, directions, sineweight, setup.render_fn(res[1]), unnormalise,
            alpha=task_cfg.prior_loss_weight, beta=task_cfg.cosine_similarity_weight,
        )
        return step if wrap_step is None else wrap_step(step, res)

    return tasks.fit_task(model, params, task_cfg, gt_at, generator, step_builder=build, **fit_kw)
