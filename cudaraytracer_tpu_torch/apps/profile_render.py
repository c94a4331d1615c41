"""Where a frame's time goes on the card: random_spheres (``--textured``:
with images), textured_globe, the textured icosphere or the 128,000- and
1,044,480-triangle fields (``--scene``) through ``render_image`` at
several ``ray_chunk`` sizes, on the fused engine (the default; on the
fields ``--no-compact-auto`` takes the monolithic route in place of the
phased one), on the wavefront through the sweep kernels (``--engine
wavefront``), or through ``--engine mega_diff`` (with ``--grad`` the
sphere centres require a gradient, so the forward records its winners).

For each chunk size: seconds per frame (min of 3 after a warm-up, CUDA
events), then one frame under ``torch.profiler``: device time by kernel,
host time by operator, and the program's spans (``utils/profiling``:
count, host ms and device ms by name).  The device's busy share of a frame
is the profiled device time over the frame time measured WITHOUT the
profiler (the profiler's own host cost stretches the profiled frame, so
dividing by it would overstate the idle share).  Prints a few lines per
chunk size and, last, one JSON object.

    python -m cudaraytracer_tpu_torch.apps.profile_render \
        --ray-chunk 262144 4194304 33554432
    python -m cudaraytracer_tpu_torch.apps.profile_render \
        --engine wavefront --ray-chunk 262144 4194304
    python -m cudaraytracer_tpu_torch.apps.profile_render \
        --engine mega_diff --grad --ray-chunk 262144
    python -m cudaraytracer_tpu_torch.apps.profile_render \
        --scene tex_icosphere --width 1280 --height 720 --spp 8 --fixed
    python -m cudaraytracer_tpu_torch.apps.profile_render \
        --scene big_field --width 1280 --height 720 --spp 8 --fixed
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def _times(prof):
    """({kernel or copy name: device us}, {host op name: self host us}).
    Device time is read from the device's own events only: the operator
    entries repeat their kernels' time, and the program's spans, which
    the profiler also puts on the device's timeline, are left out."""
    import torch

    from ..utils import profiling
    spans = set(profiling.summary())
    device, host = {}, {}
    for e in prof.events():
        if e.name in spans:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            device[e.name] = device.get(e.name, 0.0) + us
        elif e.self_cpu_time_total > 0:
            host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total
    return device, host


def _top(times, k=8):
    """The k largest entries in ms, names cut to 60 characters (a cut name
    that repeats keeps its largest entry)."""
    out = {}
    for name, us in sorted(times.items(), key=lambda kv: -kv[1])[:k]:
        out.setdefault(name[:60], us / 1e3)
    return out


def print_spans(spans: dict) -> None:
    """The program's spans of the profiled item (``profiling.summary()``),
    one line each, by host time."""
    for name, s in sorted(spans.items(), key=lambda kv: -kv[1]["host_ms"]):
        dev = ("" if s["device_ms"] is None
               else f", device {s['device_ms']:.2f} ms")
        print(f"  span {name}: {s['count']} x, host {s['host_ms']:.2f} ms"
              f"{dev}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--ray-chunk", type=int, nargs="+",
                    default=[1 << 18, 1 << 22, 1 << 25])
    ap.add_argument("--engine", default="mega",
                    choices=["mega", "wavefront", "mega_diff"])
    ap.add_argument("--scene", default="random_spheres",
                    choices=["random_spheres", "textured_globe",
                             "tex_icosphere", "big_field", "big1m"])
    ap.add_argument("--integrator", default="path",
                    choices=["path", "lambert", "normal"])
    ap.add_argument("--no-compact-auto", action="store_true",
                    help="cfg.compact_auto off: the fields' path render "
                         "runs monolithic")
    ap.add_argument("--textured", action="store_true",
                    help="random_spheres with about 1 in 5 small "
                         "lambertians on an image")
    ap.add_argument("--fixed", action="store_true",
                    help="Quirks.fixed() (default: the reference quirks)")
    ap.add_argument("--grad", action="store_true",
                    help="the sphere centres require a gradient (the frame "
                         "keeps its autograd graph; mega_diff records)")
    args = ap.parse_args(argv)

    import torch

    from ..config import Quirks, RenderConfig
    from ..core.device import resolve_device
    from ..models import check_scenes, presets
    from ..ops.megakernel import morton_tables
    from ..ops.render import render_image, sweep_intersector
    from ..utils import profiling

    dev = resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    aspect = args.width / args.height
    if args.scene in ("tex_icosphere", "big_field", "big1m"):
        scene, cam = getattr(check_scenes, args.scene + "_scene")(
            aspect, device=dev)
    elif args.scene == "textured_globe":
        scene, cam = presets.textured_globe(aspect, device=dev)
    else:
        scene, cam = presets.random_spheres(aspect, textured=args.textured,
                                            device=dev)
    quirks = Quirks.fixed() if args.fixed else Quirks.reference()
    mega = args.engine != "wavefront"
    tables = morton_tables(scene) if mega else None
    if args.grad:
        sp = scene.spheres
        scene = scene._replace(spheres=sp._replace(
            center=sp.center.clone().requires_grad_()))
    rays = args.width * args.height * args.spp
    rows = []
    for chunk in args.ray_chunk:
        cfg = RenderConfig(width=args.width, height=args.height,
                           samples=args.spp, max_depth=args.max_depth,
                           integrator=args.integrator, quirks=quirks,
                           engine=args.engine, ray_chunk=chunk,
                           compact_auto=not args.no_compact_auto)
        gen = torch.Generator(device=dev).manual_seed(0)
        isect = None if mega else sweep_intersector(cfg)

        def frame():
            with torch.set_grad_enabled(args.grad):
                return render_image(scene, cam, cfg, generator=gen,
                                    tables=tables, intersect_fn=isect)

        frame()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            frame()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        profiling.clear()
        with torch.profiler.profile(activities=acts) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            frame()
            end.record()
            torch.cuda.synchronize()
        prof_ms = start.elapsed_time(end)
        kernels, host = _times(prof)
        device_ms = sum(kernels.values()) / 1e3
        row = {"ray_chunk": chunk, "s_per_frame": best / 1e3,
               "mrays_per_s": rays / (best / 1e3) / 1e6,
               "profiled_frame_ms": prof_ms,
               "device_ms": device_ms if kernels else None,
               "busy_share": device_ms / best if kernels else None,
               "top_kernels_ms": _top(kernels),
               "top_host_ms": _top(host),
               "spans": profiling.summary()}
        rows.append(row)
        busy = (f"{row['busy_share']:.1%}" if kernels else "not measured")
        print(f"ray_chunk {chunk}: {best / 1e3:.4f} s/frame "
              f"({row['mrays_per_s']:.1f} Mrays/s); profiled frame "
              f"{prof_ms:.1f} ms, device busy {busy}")
        for what in ("top_kernels_ms", "top_host_ms"):
            print(f"  {what}: " + ", ".join(
                f"{k[:40]} {v:.2f}" for k, v in row[what].items()))
        print_spans(row["spans"])
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "power": smi, "scene": args.scene,
                      "textured": args.textured, "engine": args.engine,
                      "integrator": args.integrator,
                      "compact_auto": not args.no_compact_auto,
                      "grad": args.grad, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
