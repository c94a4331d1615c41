"""Where a frame's time goes on the card: random_spheres through
``render_image`` at several ``ray_chunk`` sizes.

For each chunk size: seconds per frame (min of 3 after a warm-up, CUDA
events), then one frame under ``torch.profiler``: device time by kernel and
host time by operator.  The device's busy share of a frame is the
profiled device time over the frame time measured WITHOUT the profiler
(the profiler's own host cost stretches the profiled frame, so dividing by
it would overstate the idle share).  Prints a few lines per chunk size
and, last, one JSON object.

    python -m cudaraytracer_tpu_torch.apps.profile_render \
        --ray-chunk 262144 4194304 33554432
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def _times(prof):
    """({kernel or copy name: device us}, {host op name: self host us}).
    Device time is read from the device's own events only: the operator
    entries repeat their kernels' time."""
    import torch
    device, host = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            device[e.name] = device.get(e.name, 0.0) + us
        elif e.self_cpu_time_total > 0:
            host[e.name] = host.get(e.name, 0.0) + e.self_cpu_time_total
    return device, host


def _top(times, k=5):
    return {name[:60]: us / 1e3 for name, us in
            sorted(times.items(), key=lambda kv: -kv[1])[:k]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--ray-chunk", type=int, nargs="+",
                    default=[1 << 18, 1 << 22, 1 << 25])
    args = ap.parse_args(argv)

    import torch

    from ..config import RenderConfig
    from ..core.device import resolve_device
    from ..models import presets
    from ..ops.megakernel import morton_tables
    from ..ops.render import render_image

    dev = resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    scene, cam = presets.random_spheres(aspect=args.width / args.height,
                                        device=dev)
    tables = morton_tables(scene)
    rays = args.width * args.height * args.spp
    rows = []
    for chunk in args.ray_chunk:
        cfg = RenderConfig(width=args.width, height=args.height,
                           samples=args.spp, max_depth=args.max_depth,
                           engine="mega", ray_chunk=chunk)
        gen = torch.Generator(device=dev).manual_seed(0)

        def frame():
            return render_image(scene, cam, cfg, generator=gen,
                                tables=tables)

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
               "top_host_ms": _top(host)}
        rows.append(row)
        busy = (f"{row['busy_share']:.1%}" if kernels else "not measured")
        print(f"ray_chunk {chunk}: {best / 1e3:.4f} s/frame "
              f"({row['mrays_per_s']:.1f} Mrays/s); profiled frame "
              f"{prof_ms:.1f} ms, device busy {busy}")
        for what in ("top_kernels_ms", "top_host_ms"):
            print(f"  {what}: " + ", ".join(
                f"{k[:40]} {v:.2f}" for k, v in row[what].items()))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "power": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
