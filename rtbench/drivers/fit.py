"""SGD steps back to back: the step that ``parallel.train.make_fit_step``
returns (forward through the wavefront and its sweep kernels, the
backward, the SGD update), each step's loss read to the host.  Step k
draws from a generator seeded from (the run's seed, k), so every step
renders other rays.

Set-up renders the target from the true scene (the fused engine at the
cell's shape, a generator seeded from the run's seed), builds the step and
the perturbed parameters (``chip_smoke.fit_scene``'s: albedos x 0.6 +
0.1, centres + 0.05), and drives the first step through the same step
object that the window then drives on.

The check compares two steps, each on its loss and each leaf's gradient
norm as the SGD step applied it ((start - after the step) / lr):

- the first, which the reference follows from its own start (the same
  perturbation of its own scene arrays), its own target, rays and tracer;
- the last step driven, which the reference follows from the parameters
  that the program held before it.  Only that start is the program's:
  the first step checks the start by itself.  Following the whole
  trajectory is not compared: parameters a step apart differ in the last
  place and the gradients, dominated by grazing rays, follow the ulps
  (PERF.md).
"""

from __future__ import annotations

import statistics
import time

import torch

from .. import seeds
from ..inputs import one_weekend
from ..reference import camera as ref_cam
from ..reference import fit as ref_fit
from ..reference import tracer
from . import _common

STEP_TAG, TARGET_TAG = 0x57, 0x7A
LEAVES = ("centers", "albedo")


def leaf_gaps(prog: dict, ref: dict, rule: list) -> float:
    """The worst leaf's gap between two norms: |prog - ref| over the
    larger of ref and the median leaf's ref, the leaves in ``rule``
    only."""
    med = statistics.median(ref[k] for k in rule)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in rule)


class Driver:
    traced_units = 2

    def __init__(self, cell, seed: int, device, spans):
        self.cell, self.seed = cell, seed
        self.device, self.spans = device, spans
        self.s = cell.settings
        self.lr = cell.spec["lr"]
        self.steps = 0
        self.record = {}        # 0 and "last" -> (step, before, loss, after)

    def step_seed(self, k: int) -> int:
        return seeds.derive(self.seed, STEP_TAG, k)

    def setup(self):
        import dataclasses

        from cudaraytracer_tpu_torch.ops.render import render_image
        from cudaraytracer_tpu_torch.parallel.train import make_fit_step
        s, dev = self.s, self.device
        self.arrays = one_weekend.scene_arrays(self.seed)
        self.cam_params = one_weekend.camera_params(s["width"] / s["height"])
        self.scene = _common.program_scene(self.arrays, dev)
        self.camera = _common.program_camera(self.cam_params, dev)
        self.cfg = _common.render_config(s)
        with torch.no_grad():
            gen = torch.Generator(device=dev).manual_seed(
                seeds.derive(self.seed, TARGET_TAG))
            self.target = render_image(
                self.scene, self.camera,
                dataclasses.replace(self.cfg, engine="mega"),
                generator=gen).reshape(-1, 3)
        self.step_fn = make_fit_step(self.scene, self.camera, self.cfg,
                                     lr=self.lr)
        self.params = {
            "albedo": (self.scene.textures.color0 * 0.6 + 0.1)
            .requires_grad_(),
            "centers": (self.scene.spheres.center + 0.05).requires_grad_()}
        self.unit()

    def gen(self, k: int):
        return torch.Generator(device=self.device).manual_seed(
            self.step_seed(k))

    def state(self) -> dict:
        return {k: v.detach().clone() for k, v in self.params.items()}

    def unit(self) -> list:
        t0 = time.perf_counter()
        k, before = self.steps, self.state()
        with self.spans.span("step"):
            loss, self.params = self.step_fn(self.params, self.target,
                                             self.gen(k))
            value = float(loss)             # waits for the device
        self.record["last"] = (k, before, value, self.state())
        if k == 0:
            self.record[0] = self.record["last"]
        self.steps += 1
        return [time.perf_counter() - t0]

    def extra_spans(self):
        """Steps split into their forward and backward, each span synced
        (``train.pixel_loss`` and ``torch.autograd.grad`` on the step's own
        arguments), for the backward-over-forward ratio."""
        from cudaraytracer_tpu_torch.ops.render import sweep_intersector_pair
        from cudaraytracer_tpu_torch.parallel import train
        lcfg = train.fit_config(self.cfg)
        isect = sweep_intersector_pair(lcfg)
        pix = torch.arange(self.s["width"] * self.s["height"],
                           device=self.device)
        leaves = [self.params[k] for k in self.params]
        for k in range(3):
            gen = self.gen(10 ** 6 + k)
            with self.spans.span("forward"):
                loss = train.pixel_loss(self.scene, self.params, self.camera,
                                        lcfg, pix, self.target, gen, isect)
                float(loss.detach())
            with self.spans.span("backward"):
                grads = torch.autograd.grad(loss, leaves)
                float(grads[0].sum())

    def release(self):
        self.step_fn = self.scene = self.camera = self.target = None
        self.params = None

    def reference_target(self, dtype):
        """The reference's target [n_pix, 3]: the true scene, the target's
        draws, in the renderer's swizzled pixel order."""
        s, dev = self.s, self.device
        n_pix = s["width"] * s["height"]
        order = ref_cam.swizzled_pixels(s["width"], s["height"], dev)
        gen = torch.Generator(device=dev).manual_seed(
            seeds.derive(self.seed, TARGET_TAG))
        rays = ref_cam.replay_rays(self.ref_cam, s["width"], s["height"],
                                   s["samples"], s["ray_chunk"], gen, order,
                                   torch.arange(n_pix, device=dev), True)
        prims = tracer.sphere_prims(self.arrays, dev, dtype)
        with torch.no_grad():
            px = tracer.finish(tracer.render_rays(
                prims, rays.origin.to(dtype), rays.direction.to(dtype),
                rays.seed, rays.index, s), s["samples"], s["gamma"],
                s["clip"])
        target = torch.empty(n_pix, 3, device=dev, dtype=dtype)
        target[rays.pixel] = px
        return target

    def reference_start(self) -> dict:
        a, dev = self.arrays, self.device
        return {"centers": torch.as_tensor(a["center"], device=dev) + 0.05,
                "albedo": torch.as_tensor(a["tex_c0"], device=dev) * 0.6
                + 0.1}

    def reference_step(self, dtype, k: int, start: dict, target) -> dict:
        """The reference's step k from ``start`` in ``dtype``: its loss and
        each leaf's gradient norm as its SGD step applied it."""
        s, dev = self.s, self.device
        start = {key: v.to(dtype) for key, v in start.items()}
        rows = torch.arange(s["width"] * s["height"], device=dev)
        rays = ref_cam.replay_rays(self.ref_cam, s["width"], s["height"],
                                   s["samples"], s["ray_chunk"], self.gen(k),
                                   rows, rows, True)
        loss, g_c, g_t = ref_fit.loss_and_grads(self.arrays,
                                                start["centers"],
                                                start["albedo"], rays,
                                                target, s)
        # as the program's: (start - after the step) / lr, in the state's
        # own precision
        after = {"centers": start["centers"] - self.lr * g_c,
                 "albedo": start["albedo"] - self.lr * g_t}
        return {"loss": loss,
                "grad": {key: ((start[key] - after[key]) / self.lr).float()
                         .norm().item() for key in LEAVES}}

    def checked(self) -> list:
        """(step, the reference's start) of each compared step."""
        out = [(0, self.reference_start())]
        k_last, before, _, _ = self.record["last"]
        if k_last != 0:
            out.append((k_last, before))
        return out

    def reference_runs(self, dtype) -> list:
        self.ref_cam = ref_cam.make_camera(self.cam_params, self.device)
        target = self.reference_target(dtype)
        return [self.reference_step(dtype, k, start, target)
                for k, start in self.checked()]

    def program_runs(self) -> list:
        out = []
        for key in [0, "last"][:len(self.checked())]:
            _, before, loss, after = self.record[key]
            out.append({"loss": loss,
                        "grad": {k: ((before[k] - after[k]) / self.lr)
                                 .float().norm().item() for k in LEAVES}})
        return out

    @staticmethod
    def gaps(prog: dict, ref: dict) -> dict:
        """The compared numbers: the loss's relative gap, and the worst
        leaf's gradient-norm gap.  Leaves whose reference gradient is under
        a thousandth of the median leaf's are left out."""
        med = statistics.median(ref["grad"].values())
        rule = [k for k in LEAVES if ref["grad"][k] >= 1e-3 * med]
        out = {"loss_gap": abs(prog["loss"] - ref["loss"])
               / max(abs(ref["loss"]), 1e-30),
               "grad_gap": leaf_gaps(prog["grad"], ref["grad"], rule)}
        return {k: (v if v == v else float("inf")) for k, v in out.items()}

    def check(self, dtype) -> list:
        return [self.gaps(p, r) for p, r in zip(self.program_runs(),
                                                self.reference_runs(dtype))]

    def control(self, dtype) -> list:
        """The reference in ``dtype`` put in the program's place."""
        return [self.gaps(c, r) for c, r in zip(
            self.reference_runs(dtype), self.reference_runs(torch.float32))]
