"""Where a fit step's time goes on the card: ``make_fit_step`` at the
bench's fit shape (three_spheres, or ``--scene textured_globe``, 512x256x4,
path depth 4, no gamma, SGD at lr 0.5 on albedo and centres, the same rays
and draws every step), through the wavefront (the sweep kernels) or
``--engine mega_diff`` (the fused forward recording its winners, the replay
backward).

Seconds per step (min of 3 after a warm-up step, host clock around a step
that ends in a read of the loss), then one step under ``torch.profiler``:
device time by kernel, host time by operator, the device's busy share
(profiled device time over the unprofiled step), the program's spans
(``utils/profiling``), and from them the share of the replay's reference
bounces (``mega.replay``, in ``megakernel.replay_reference``) and of the
table builds (``mega.tables``, in ``build_mega_tables``): host time with
their operators, and the device time of what they launched.  Prints a few
lines and, last, one JSON object.

    python -m cudaraytracer_tpu_torch.apps.profile_fit --engine mega_diff \
        --scene textured_globe
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from .profile_render import _times, _top, print_spans

# the program's spans whose share of the step the report gives
LABELLED = ("mega.replay", "mega.tables")


def _label_times(prof) -> dict:
    """{span: {calls, host_ms (with its operators), device_ms (of the
    kernels launched inside)}}, from the spans' host ranges (the profiler
    also puts each range on the device's timeline, gaps included)."""
    import torch
    out = {}
    for e in prof.events():
        if (e.name in LABELLED
                and e.device_type == torch.autograd.DeviceType.CPU):
            row = out.setdefault(e.name, {"calls": 0, "host_ms": 0.0,
                                          "device_ms": 0.0})
            row["calls"] += 1
            row["host_ms"] += e.cpu_time_total / 1e3
            row["device_ms"] += e.device_time_total / 1e3
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--engine", nargs="+", default=["wavefront", "mega_diff"],
                    choices=["wavefront", "mega_diff"])
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--scene", default="three_spheres",
                    choices=["three_spheres", "textured_globe"])
    args = ap.parse_args(argv)

    import torch

    from ..config import RenderConfig
    from ..core.camera import generate_pixel_rays
    from ..core.device import resolve_device
    from ..models import presets
    from ..ops.render import render_pixels, sweep_intersector_pair
    from ..parallel.train import fit_config, make_fit_step
    from ..utils import profiling

    dev = resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    w, h, spp = args.width, args.height, args.spp
    scene, cam = getattr(presets, args.scene)(aspect=w / h, device=dev)
    rays = generate_pixel_rays(cam, w, h, spp, generator=torch.Generator(
        device=dev).manual_seed(0))
    rows = []
    for engine in args.engine:
        cfg = RenderConfig(width=w, height=h, samples=spp, max_depth=4,
                           gamma=False, engine=engine)
        lcfg = fit_config(cfg)
        isect = (sweep_intersector_pair(lcfg) if engine == "wavefront"
                 else None)
        with torch.no_grad():
            target = render_pixels(scene, cam, lcfg,
                                   torch.arange(w * h, device=dev),
                                   torch.Generator(device=dev).manual_seed(1),
                                   rays=rays, intersect_fn=isect)
        step = make_fit_step(scene, cam, cfg, lr=0.5)
        params = {"albedo": (scene.textures.color0 * 0.6 + 0.1)
                  .requires_grad_(),
                  "centers": (scene.spheres.center + 0.05).requires_grad_()}

        def run():
            loss, _ = step(params, target, torch.Generator(
                device=dev).manual_seed(1), rays=rays)
            return float(loss)          # waits for the device

        run()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        profiling.clear()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            prof_s = time.perf_counter() - t0
        kernels, host = _times(prof)
        spans = profiling.summary()
        device_ms = sum(kernels.values()) / 1e3
        row = {"engine": engine, "s_per_step": best,
               "labelled": _label_times(prof),
               "profiled_step_s": prof_s,
               "device_ms": device_ms if kernels else None,
               "busy_share": device_ms / 1e3 / best if kernels else None,
               "n_kernel_launches": sum(
                   1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name not in spans),
               "top_kernels_ms": _top(kernels, 10),
               "top_host_ms": _top(host, 10),
               "spans": spans}
        rows.append(row)
        busy = (f"{row['busy_share']:.1%}" if kernels else "not measured")
        print(f"{engine}: {best:.4f} s/step; profiled step {prof_s:.3f} s, "
              f"device {device_ms:.1f} ms, busy {busy}, "
              f"{row['n_kernel_launches']} device events")
        for name, t in row["labelled"].items():
            print(f"  {name}: {t['calls']} calls, host {t['host_ms']:.2f} "
                  f"ms ({t['host_ms'] / 1e3 / prof_s:.1%} of the profiled "
                  f"step), device {t['device_ms']:.2f} ms")
        for what in ("top_kernels_ms", "top_host_ms"):
            print(f"  {what}: " + ", ".join(
                f"{k[:40]} {v:.2f}" for k, v in row[what].items()))
        print_spans(row["spans"])
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "power": smi, "scene": args.scene,
                      "shape": [w, h, spp], "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
