"""The inverse-rendering step, plainly: the pixel loss of a path-traced
frame against a target and its gradient with respect to the spheres'
centres and the textures' colours, by autograd through
``wavefront.path_radiance`` (the closest sphere chosen without gradients,
its root computed again from the winner's centre, so the hit point, the
normal and every later bounce carry the gradient; the draws are
constants).  A frame is traced in blocks of whole pixels, each block's
share of the loss differentiated on its own, the gradients summed.
"""

from __future__ import annotations

import torch

from . import tracer as tr
from . import wavefront

Tensor = torch.Tensor


def loss_and_grads(a: dict, center: Tensor, tex_c0: Tensor, rays,
                   target: Tensor, cfg: dict, block_pixels: int = 1 << 15):
    """(loss, grad of centre, grad of texture colours) of the mean squared
    error of the finished pixels of ``rays`` (``camera.ReplayedRays``, the
    pixels' samples adjacent, in row-major pixel order) against ``target``
    [n_pix, 3].  center / tex_c0: leaf tensors of the parameters."""
    spp = cfg["samples"]
    n_pix = target.shape[0]
    dt = center.dtype
    g_c = torch.zeros_like(center)
    g_t = torch.zeros_like(tex_c0)
    total = 0.0
    for lo in range(0, n_pix, block_pixels):
        hi = min(n_pix, lo + block_pixels)
        rs = slice(lo * spp, hi * spp)
        c = center.detach().requires_grad_()
        tc = tex_c0.detach().requires_grad_()
        rad = wavefront.path_radiance(a, c, tc, rays.origin[rs].to(dt),
                                 rays.direction[rs].to(dt), rays.seed[rs],
                                 rays.index[rs], cfg)
        px = tr.finish(rad, spp, cfg["gamma"], cfg["clip"])
        part = ((px - target[lo:hi].to(dt)) ** 2).sum() / (n_pix * 3)
        gc, gt = torch.autograd.grad(part, (c, tc))
        g_c += gc
        g_t += gt
        total += float(part.detach())
    return total, g_c, g_t
