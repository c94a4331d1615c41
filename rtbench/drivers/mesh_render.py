"""Frames back to back on a static triangle mesh, as ``apps/render.py``
renders one: the program's scene built through ``SceneBuilder.add_mesh``,
its fused tables in Morton order built once (``morton_tables``), then
``ops.render.render_image`` of the whole frame with those tables, the
route left to the program (``select_mega``), each frame's pixels copied to
the host.  Frame k draws from a generator seeded from (the run's seed,
k), as ``drivers/render.py`` draws.

The check: the window's first and last frames, each at a sample of pixels
drawn from the seed, against the fixed-quirk mesh reference
(``reference/mesh.py``) on the same camera draws."""

from __future__ import annotations

import dataclasses

import torch

from ..inputs import big_field
from ..reference import camera as ref_cam
from ..reference import mesh, tracer
from . import _common, render


def render_config(s: dict):
    """The program's RenderConfig of the cell's render settings: the one
    ``_common.render_config`` makes, under the fixed quirks."""
    from cudaraytracer_tpu_torch.config import Quirks
    if s["quirks"] != "fixed":
        raise ValueError("the mesh cells run the fixed quirks")
    return dataclasses.replace(
        _common.render_config({**s, "quirks": "reference"}),
        quirks=Quirks.fixed())


def program_scene(a: dict, device):
    """The program's Scene of the mesh arrays ``a``
    (``inputs/big_field.scene_arrays``): one lambertian of constant colour
    a copy, each copy's faces through ``add_mesh`` with their normals, in
    the reversed winding."""
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    b = SceneBuilder()
    for c, albedo in enumerate(a["albedo"]):
        mine = a["copy"] == c
        b.add_mesh(a["points"], a["faces"][mine],
                   b.materials.lambertian(color=albedo),
                   normals=a["normals"][mine], reverse_winding=True)
    return b.build(device)


class Driver(render.Driver):
    def setup(self):
        from cudaraytracer_tpu_torch.ops.megakernel import morton_tables
        s, conf = self.s, self.cell.config
        if s["tables"] != "morton":
            raise ValueError("the mesh cells render from Morton tables")
        self.arrays = big_field.scene_arrays(
            self.seed, tuple(conf["copies"]), conf["subdivisions"])
        self.cam_params = big_field.camera_params(
            s["width"] / s["height"], conf["copies"][1],
            conf["subdivisions"])
        self.scene = program_scene(self.arrays, self.device)
        self.camera = _common.program_camera(self.cam_params, self.device)
        self.cfg = render_config(s)
        self.tables = morton_tables(self.scene)
        self.frame(-1)          # warm-up: every shape of a frame

    def frame(self, k: int):
        from cudaraytracer_tpu_torch.ops.render import render_image
        gen = torch.Generator(device=self.device).manual_seed(
            self.frame_seed(k))
        img = render_image(self.scene, self.camera, self.cfg, generator=gen,
                           tables=self.tables)
        return img.cpu().numpy()

    def release(self):
        super().release()
        self.tables = None

    def reference_pixels(self, k: int, dtype) -> torch.Tensor:
        """The reference's finished pixels of frame k at ``self.pixels``
        (in that order) -> [P, 3]."""
        s, dev, a = self.s, self.device, self.arrays
        cam = ref_cam.make_camera(self.cam_params, dev)
        order, pos, back = _common.swizzle_positions(
            s["width"], s["height"], self.pixels, dev)
        gen = torch.Generator(device=dev).manual_seed(self.frame_seed(k))
        rays = ref_cam.replay_rays(cam, s["width"], s["height"], s["samples"],
                                   s["ray_chunk"], gen, order, pos, True)
        prims = mesh.mesh_prims(
            torch.as_tensor(big_field.triangles(a), device=dev),
            torch.as_tensor(a["normals"], device=dev),
            torch.as_tensor(a["albedo"][a["copy"]], device=dev), dtype)
        rad = mesh.render_rays(prims, rays.origin.to(dtype),
                               rays.direction.to(dtype), rays.seed,
                               rays.index, s)
        return tracer.finish(rad, s["samples"], s["gamma"],
                             s["clip"]).float()[back]
