"""The mesh-scaling harness (the JAX package's ``apps/scaling.py``): times
the dp scaling of the sharded render (the wavefront and ``engine='mega'``)
and the fit step with per-bounce (overlapped) against post-hoc gradient
reduction, and writes one JSON report to ``--out``.

Ranks run on the CUDA card (NCCL when every rank has a card of its own,
else gloo ranks sharing one card; no card raises), or with ``--cpu``
through gloo on the host's cores.  Ranks sharing one card, or a host's
cores, measure no scaling: the report says so.  Each dp count is one spawn
of that many ranks; a frame's time is the slowest rank's (each rank's
time is all-reduced with MAX).

    python -m cudaraytracer_tpu_torch.apps.scaling --out scaling.json \\
        [--devices 4] [--cpu] [--width 256] [--height 128]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _parser():
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", required=True,
                    help="where to write the JSON report")
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU through gloo (default: "
                         "the CUDA card)")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--samples", type=int, default=2)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    return ap


def _timed(fn, iters: int) -> float:
    """Seconds per call, after one warm-up, the slowest rank's."""
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import all_reduce
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    t = torch.tensor([(time.perf_counter() - t0) / iters],
                     dtype=torch.float64, device=out.device)
    return float(all_reduce(t, dist.ReduceOp.MAX, dist.group.WORLD))


def scaling_rank(device, args, fit: bool) -> dict:
    """One rank of a dp count's spawn: both engines' sharded renders over
    a (world, 1) mesh, and with ``fit`` the two fit steps over (world / tp,
    tp)."""
    import torch
    import torch.distributed as dist

    from ..config import RenderConfig
    from ..models import presets
    from ..parallel.mesh import make_mesh
    from ..parallel.render import member_generator, render_image_sharded
    from ..parallel.train import make_fit_step

    world = dist.get_world_size()
    scene, cam = presets.three_spheres(aspect=args.width / args.height,
                                       device=device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples=args.samples, max_depth=args.depth,
                       integrator="path", ray_chunk=1 << 20)
    mesh = make_mesh(world, tp=1)
    out = {}
    for engine in ("wavefront", "mega"):
        ecfg = dataclasses.replace(cfg, engine=engine)
        with torch.no_grad():
            out[engine] = _timed(lambda: render_image_sharded(
                scene, cam, ecfg, mesh), args.iters)
    if fit:
        tp = 2 if world % 2 == 0 else 1
        fmesh = make_mesh(world, tp=tp)
        target = torch.zeros(args.width * args.height, 3, device=device)
        for name, overlap in (("posthoc_pmean", False), ("overlapped", True)):
            step = make_fit_step(scene, cam, dataclasses.replace(
                cfg, gamma=False), lr=0.1, mesh=fmesh, overlap_grads=overlap)

            def run():
                params = {"centers": scene.spheres.center.clone()
                          .requires_grad_(),
                          "albedo": scene.textures.color0.clone()
                          .requires_grad_()}
                gen = member_generator(1, fmesh.rank, device)
                return step(params, target, gen)[0]

            out[name] = _timed(run, args.iters)
        out["fit_mesh"] = fmesh.shape
    return out


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    import torch

    from ..core.device import resolve_device
    from ..parallel.mesh import choose_backend, spawn
    device = resolve_device("cpu" if args.cpu else None)
    cores = os.cpu_count()
    dps = [d for d in (1, 2, 4, 8, 16) if d < args.devices] + [args.devices]
    report = {"device": device.type, "devices": args.devices,
              "workload": f"{args.width}x{args.height}x{args.samples}spp "
                          f"path{args.depth} three_spheres",
              "render_strong_scaling": {}, "render_strong_scaling_mega": {},
              "fit_step": {}}
    shared = (device.type == "cpu"
              or choose_backend(args.devices, device) == "gloo")
    if device.type == "cuda":
        report["card"] = torch.cuda.get_device_name(0)
        report["cards"] = torch.cuda.device_count()
    else:
        report["host_cores"] = cores
    if shared:
        report["note"] = (
            "the ranks share one card or the host's cores, so these numbers "
            "measure no scaling: they show the collectives' and the tiling's "
            "cost, and a ratio that moves between commits flags a "
            "serialising collective; scaling needs a card a rank")
    t_ref = {}
    for dp in dps:
        threads = max(1, cores // dp) if device.type == "cpu" else 0
        out = spawn(scaling_rank, dp, (args, dp == args.devices),
                    device=device, threads=threads)[0]
        for engine, key in (("wavefront", "render_strong_scaling"),
                            ("mega", "render_strong_scaling_mega")):
            t = out[engine]
            t_ref.setdefault(engine, t)
            eff = t_ref[engine] / (dp * t)
            report[key][f"dp{dp}"] = {"sec_per_frame": t, "efficiency": eff}
            print(f"render[{engine}] dp={dp}: {t:.4f} s/frame, efficiency "
                  f"{eff:.2f}", flush=True)
        if dp == args.devices:
            for name in ("posthoc_pmean", "overlapped"):
                report["fit_step"][name] = {"sec_per_step": out[name],
                                            "mesh": out["fit_mesh"]}
                print(f"fit {name}: {out[name]:.4f} s/step", flush=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
