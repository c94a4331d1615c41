"""Frames back to back: ``ops.render.render_image`` of the whole frame on
a static scene, each frame's pixels copied to the host (as the reference
copies them before its PNG).  Frame k draws from a generator seeded from
(the run's seed, k); the scene is built once.

The check: two frames of the window (its first and its last), each at a
sample of pixels drawn from the seed, against the reference tracer on the
same camera draws."""

from __future__ import annotations

import numpy as np
import torch

from .. import seeds
from ..inputs import one_weekend
from ..reference import camera as ref_cam
from ..reference import tracer
from . import _common

FRAME_TAG, PICK_TAG = 0xF7, 0x9C


class Driver:
    traced_units = 3

    def __init__(self, cell, seed: int, device, spans):
        self.cell, self.seed = cell, seed
        self.device, self.spans = device, spans
        self.s = cell.settings
        self.frames = 0
        self.kept = {}          # frame -> picked pixels [P, 3] on the host
        self.pixels = _common.picks(seed, PICK_TAG, self.s["width"],
                                    self.s["height"], cell.spec["picks"])

    def setup(self):
        s = self.s
        self.arrays = one_weekend.scene_arrays(self.seed)
        self.cam_params = one_weekend.camera_params(s["width"] / s["height"])
        self.scene = _common.program_scene(self.arrays, self.device)
        self.camera = _common.program_camera(self.cam_params, self.device)
        self.cfg = _common.render_config(s)
        self.pix = torch.as_tensor(self.pixels, device=self.device)
        self.frame(-1)          # warm-up: every shape of a frame

    def frame_seed(self, k: int) -> int:
        return seeds.derive(self.seed, FRAME_TAG, k & 0xFFFFFFFF)

    def frame(self, k: int) -> np.ndarray:
        from cudaraytracer_tpu_torch.ops.render import render_image
        gen = torch.Generator(device=self.device).manual_seed(
            self.frame_seed(k))
        img = render_image(self.scene, self.camera, self.cfg, generator=gen)
        return img.cpu().numpy()

    def unit(self) -> list:
        import time
        t0 = time.perf_counter()
        k = self.frames
        with self.spans.span("frame"):
            img = self.frame(k)
        dt = time.perf_counter() - t0
        self.frames += 1
        keep = img.reshape(-1, 3)[self.pixels]
        if k == 0:
            self.kept[0] = keep
        self.kept["last"] = (k, keep)
        return [dt]

    def extra_spans(self):
        pass

    def release(self):
        self.scene = self.camera = self.pix = None

    def reference_pixels(self, k: int, dtype) -> torch.Tensor:
        """The reference's finished pixels of frame k at ``self.pixels``
        (in that order) -> [P, 3]."""
        s, dev = self.s, self.device
        cam = ref_cam.make_camera(self.cam_params, dev)
        order, pos, back = _common.swizzle_positions(
            s["width"], s["height"], self.pixels, dev)
        gen = torch.Generator(device=dev).manual_seed(self.frame_seed(k))
        rays = ref_cam.replay_rays(cam, s["width"], s["height"], s["samples"],
                                   s["ray_chunk"], gen, order, pos,
                                   s["integrator"] == "path")
        prims = tracer.sphere_prims(self.arrays, dev, dtype)
        rad = tracer.render_rays(prims, rays.origin.to(dtype),
                                 rays.direction.to(dtype), rays.seed,
                                 rays.index, s)
        px = tracer.finish(rad, s["samples"], s["gamma"], s["clip"]).float()
        return px[back]

    def checked(self):
        k_last, last = self.kept["last"]
        out = [(0, self.kept[0])]
        if k_last != 0:
            out.append((k_last, last))
        return out

    def check(self, dtype) -> list:
        return [_common.pixel_gaps(
                    torch.as_tensor(got, device=self.device),
                    self.reference_pixels(k, dtype))
                for k, got in self.checked()]

    def control(self, dtype) -> list:
        """The reference in ``dtype`` put in the program's place."""
        return [_common.pixel_gaps(self.reference_pixels(k, dtype),
                                   self.reference_pixels(k, torch.float32))
                for k, _ in self.checked()]
