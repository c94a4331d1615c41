"""Inverse-rendering demo on the port: recover sphere positions and albedos
of three_spheres from a target image by gradient descent on the pixel
loss, through the wavefront engine and the sweep kernels, or (--engine
mega_diff) through the fused kernel and the replay backward.

The target is rendered from the true scene; the fit starts from perturbed
parameters.  Runs on the CUDA card, or with --cpu on the plain PyTorch
path.  Same flags as the JAX package's apps/fit.py; --devices / --tp above
1 are not ported yet and raise.

    python -m cudaraytracer_tpu_torch.apps.fit --cpu --steps 20 \\
        --width 48 --height 27 --samples 2 [--engine mega_diff]
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
                    help="pixel shards (dp); only 1 is ported")
    ap.add_argument("--tp", type=int, default=1,
                    help="prim shards; only 1 is ported")
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

    import numpy as np
    import torch

    from ..config import RenderConfig
    from ..core.device import resolve_device
    from ..models import presets
    from ..ops.render import render_image
    from ..parallel.train import apply_sphere_params, fit
    from ..utils.checkpoint import load_params, save_params
    from ..utils.convert import params_from_numpy, to_numpy
    from ..utils.image import write_png

    devices = 1 if args.devices is None else args.devices
    if devices * args.tp != 1:
        raise NotImplementedError(
            f"--devices {devices} --tp {args.tp}: multi-device fits are not "
            "ported yet: ROADMAP Queue 1 item 20 (slice 7)")
    device = resolve_device("cpu" if args.cpu else None)
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
    write_png(os.path.join(args.out, "init.png"),
              np.sqrt(to_numpy(render(apply_sphere_params(scene, params),
                                      7))))
    print(f"device: {device}")
    c_err0 = float(np.abs(true_centers - to_numpy(params["centers"])).max())
    a_err0 = float(np.abs(true_albedo - to_numpy(params["albedo"])).max())

    ckpt_path = os.path.join(args.out, "fit_ckpt.npz")
    step0 = 0
    if args.resume and os.path.exists(ckpt_path):
        loaded, step0, _ = load_params(ckpt_path)
        params = params_from_numpy(loaded, device)
        print(f"resumed {ckpt_path} at step {step0}")

    losses = []
    remaining = max(args.steps - step0, 0)
    chunk = args.checkpoint_every if args.checkpoint_every > 0 else remaining
    done = step0
    while remaining > 0:
        n = min(chunk, remaining)
        params, ls = fit(scene, params, cam, cfg, target, steps=n,
                         lr=args.lr, seed=done, verbose=True)
        losses.extend(ls)
        done += n
        remaining -= n
        if args.checkpoint_every > 0:
            save_params(ckpt_path, params, done)
    if not losses:
        print(f"checkpoint already at step {step0} >= --steps {args.steps}; "
              "nothing to do")
        return 0

    c_err1 = float(np.abs(true_centers - to_numpy(params["centers"])).max())
    a_err1 = float(np.abs(true_albedo - to_numpy(params["albedo"])).max())
    print(f"center err: {c_err0:.4f} -> {c_err1:.4f}")
    print(f"albedo err: {a_err0:.4f} -> {a_err1:.4f}")
    print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f}")
    write_png(os.path.join(args.out, "fitted.png"),
              np.sqrt(to_numpy(render(apply_sphere_params(scene, params),
                                      7))))
    print(f"wrote {args.out}/target.png, init.png, fitted.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
