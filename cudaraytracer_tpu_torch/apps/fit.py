"""Inverse-rendering demo on the port: recover sphere positions and albedos
of three_spheres from a target image by gradient descent on the pixel
loss, through the wavefront engine and the sweep kernels, or (--engine
mega_diff) through the fused kernel and the replay backward.

The target is rendered from the true scene; the fit starts from perturbed
parameters.  Runs on the CUDA card, or with --cpu on the plain PyTorch
path.  Same flags as the JAX package's apps/fit.py.

--devices N --tp M fits over N ranks on a (N / M, M) mesh
(``parallel.train``: one pixel tile a rank, the gradients averaged per
bounce).  Under ``torchrun --nproc-per-node N`` each rank joins the group
that torchrun describes; otherwise the command spawns N local ranks itself
(gloo when they share one card or run on the CPU, NCCL when each has a
card of its own).  Rank 0 prints and writes the PNGs and the checkpoint.

    python -m cudaraytracer_tpu_torch.apps.fit --cpu --steps 20 \\
        --width 48 --height 27 --samples 2 [--engine mega_diff] \\
        [--devices 2 [--tp 2]]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks (default: --tp); pixel tiles over dp x tp")
    ap.add_argument("--tp", type=int, default=1,
                    help="the mesh's tp axis (must divide --devices)")
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=54)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--cpu-devices", type=int, default=8,
                    help="accepted for the JAX CLI's sake; unused")
    ap.add_argument("--engine", default="wavefront",
                    choices=["wavefront", "mega_diff"],
                    help="wavefront = the sweep pair (K3/K4) and the "
                         "attribute-carrying sphere sweep (K5); mega_diff "
                         "= the fused kernel recording its winners (K7) "
                         "and the replay backward")
    ap.add_argument("--out", default="fit_out")
    ap.add_argument("--checkpoint-every", type=int, default=25,
                    help="save params every N steps (0 disables)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from <out>/fit_ckpt.npz if present")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    devices = args.tp if args.devices is None else args.devices
    if devices < 1 or args.tp < 1 or devices % args.tp:
        ap.error(f"--devices {devices} is not a multiple of --tp {args.tp}")
    device = "cpu" if args.cpu else None
    if devices == 1:
        from ..core.device import resolve_device
        return run(args, resolve_device(device))
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed, spawn
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dev = init_distributed(device=device)
        try:
            return fit_rank(dev, args)
        finally:
            dist.destroy_process_group()
    spawn(fit_rank, devices, (args,), device=device,
          threads=1 if args.cpu else 0)
    return 0


def fit_rank(device, args) -> int:
    """One rank of a multi-rank fit (``spawn`` or torchrun)."""
    from ..parallel.mesh import make_mesh
    devices = args.tp if args.devices is None else args.devices
    return run(args, device, make_mesh(devices, args.tp))


def run(args, device, mesh=None) -> int:
    """The fit on ``device``; over ``mesh`` every rank runs it and rank 0
    reports and writes."""
    import numpy as np
    import torch

    from ..config import RenderConfig
    from ..models import presets
    from ..ops.render import render_image
    from ..parallel.train import apply_sphere_params, fit
    from ..utils.checkpoint import load_params, save_params
    from ..utils.convert import params_from_numpy, to_numpy
    from ..utils.image import write_png

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    scene, cam = presets.three_spheres(aspect=args.width / args.height,
                                       device=device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples=args.samples, max_depth=4, integrator="path",
                       gamma=False, engine=args.engine,
                       wavefront_kernel_attrs=True)

    def render(s, seed):
        with torch.no_grad():
            return render_image(s, cam, cfg, generator=torch.Generator(
                device=device).manual_seed(seed))

    target = render(scene, 1234)
    if lead:
        os.makedirs(args.out, exist_ok=True)
        write_png(os.path.join(args.out, "target.png"),
                  np.sqrt(to_numpy(target)))

    rng = np.random.default_rng(0)
    true_centers = to_numpy(scene.spheres.center)
    true_albedo = to_numpy(scene.textures.color0)
    params = params_from_numpy({
        "centers": true_centers + rng.normal(
            scale=0.08, size=true_centers.shape).astype(np.float32),
        "albedo": np.clip(true_albedo + rng.normal(
            scale=0.15, size=true_albedo.shape).astype(np.float32), 0, 1),
    }, device)
    init = render(apply_sphere_params(scene, params), 7)
    if lead:
        write_png(os.path.join(args.out, "init.png"),
                  np.sqrt(to_numpy(init)))
    say(f"device: {device}" + ("" if mesh is None else
                               f", mesh {mesh.shape} of ranks"))
    c_err0 = float(np.abs(true_centers - to_numpy(params["centers"])).max())
    a_err0 = float(np.abs(true_albedo - to_numpy(params["albedo"])).max())

    ckpt_path = os.path.join(args.out, "fit_ckpt.npz")
    step0 = 0
    if args.resume and os.path.exists(ckpt_path):
        loaded, step0, _ = load_params(ckpt_path)
        params = params_from_numpy(loaded, device)
        say(f"resumed {ckpt_path} at step {step0}")

    losses = []
    remaining = max(args.steps - step0, 0)
    chunk = args.checkpoint_every if args.checkpoint_every > 0 else remaining
    done = step0
    while remaining > 0:
        n = min(chunk, remaining)
        params, ls = fit(scene, params, cam, cfg, target, steps=n,
                         lr=args.lr, seed=done, verbose=lead, mesh=mesh)
        losses.extend(ls)
        done += n
        remaining -= n
        if args.checkpoint_every > 0 and lead:
            save_params(ckpt_path, params, done)
    if not losses:
        say(f"checkpoint already at step {step0} >= --steps {args.steps}; "
            "nothing to do")
        return 0

    c_err1 = float(np.abs(true_centers - to_numpy(params["centers"])).max())
    a_err1 = float(np.abs(true_albedo - to_numpy(params["albedo"])).max())
    say(f"center err: {c_err0:.4f} -> {c_err1:.4f}")
    say(f"albedo err: {a_err0:.4f} -> {a_err1:.4f}")
    say(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f}")
    fitted = render(apply_sphere_params(scene, params), 7)
    if lead:
        write_png(os.path.join(args.out, "fitted.png"),
                  np.sqrt(to_numpy(fitted)))
    say(f"wrote {args.out}/target.png, init.png, fitted.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
