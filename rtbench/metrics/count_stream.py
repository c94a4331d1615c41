"""Count, once, on the card, the work of a frame of ``big_field.path8`` for
``stream_roofline``: the tests and bytes of its fused launches (K6, K10,
K11) through the program's counting instance, at seed 0, frame 0, chunk
by chunk as ``render_pixels`` draws them, on each of the three routes
that give this frame bit for bit:

- ``default``: ``select_mega``'s route (phased every 2 bounces, octant
  regrouping, 8 front-to-back shells);
- ``monolithic``: ``compact_auto`` off, one launch a chunk;
- ``monolithic_f2b8``: ``compact_auto`` off with 8 shells.

The lowest of the three bounds is frozen (of equal bounds, the fewest
FLOPs, then bytes), so that a later change of route cannot read above
100%.

    python3 rtbench/metrics/count_stream.py

prints one JSON object.  The arithmetic is ``count_work.py``'s (a test's
FLOPs as the kernel writes it: slab 24, triangle 46, K11's box distance
21; the box and segment tables, the rows of the chunks whose prims a
chunk's launches tested, counted once a chunk), with the bytes a route's
fused launches move themselves: a monolithic launch reads its camera rays
(24 B) and writes its radiance (12 B); a bounce window (K10) at step 0
reads the camera rays and writes each ray's 13 planes (52 B), a later one
reads each ray's alive flag and its order entry (8 B, 4 with no order)
and, for a ray alive at its start, its other 12 planes (48 B) and writes
all 13 back (52 B); a window that keys writes each started or resumed
ray's key (4 B).  The sorts between windows are no fused launch and are
left out, as their kernels are of the roofline's time.  Each route's
kernel names under the profiler are listed beside the counts, so that
the pattern can be checked against every fused instance a frame runs."""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rtbench import stats  # noqa: E402
from rtbench.metrics import _read  # noqa: E402
from rtbench.metrics.count_work import (FLOP_BOX, FLOP_DIST,  # noqa: E402
                                        FLOP_TRI, SEED, _add, _cell)

CELL = "big_field.path8"
KERNEL_PATTERN = r"crt::mega_(kernel|path)"
ROUTES = (("default", {}),
          ("monolithic", {"compact_auto": False}),
          ("monolithic_f2b8", {"compact_auto": False, "mega_f2b_shells": 8}))


def _chunk_work(mk, integ, scene, tables, rays, cfg, seed) -> dict:
    """One chunk through ``integrate`` (the route ``cfg`` gives), each of
    its fused launches through the counting instance -> its FLOPs, bytes
    and counts."""
    import torch
    dev = rays.origin.device
    n = rays.origin.shape[0]
    n_sc = tables.sph_box.shape[0]
    counts = torch.zeros(mk.N_COUNTS, dtype=torch.int64, device=dev)
    touched = torch.zeros(max(n_sc + tables.tri_box.shape[0], 1),
                          dtype=torch.uint8, device=dev)
    work = torch.zeros(mk.N_WORK, dtype=torch.int64, device=dev)
    state = {"launches": 0, "state_bytes": 0}
    real = mk._trace

    def counting(tables, o, d, cfg, stream, seed, want_winners=False,
                 window=mk.WHOLE):
        w = window
        if w.planes is None:
            state["state_bytes"] += 12 * n
        elif w.step_lo == 0:
            state["state_bytes"] += 52 * n + (4 * n if w.key is not None
                                              else 0)
        else:
            alive = int((w.planes[mk.PL_ALIVE] > 0.0).sum())
            state["state_bytes"] += ((8 if w.order is not None else 4) * n
                                     + 100 * alive
                                     + (4 * alive if w.key is not None
                                        else 0))
        state["launches"] += 1
        return mk._launch_mega(tables, o.contiguous(), d.contiguous(), cfg,
                               stream, seed, counts=counts, touched=touched,
                               window=window, work=work)

    mk._trace = counting
    try:
        integ.integrate(scene, rays, cfg, tables=tables, seed=seed)
    finally:
        mk._trace = real
    t = dict(zip(mk.COUNT_NAMES, counts.tolist()))
    t.update(zip(mk.WORK_NAMES, work.tolist()))
    tri_chunks = int(touched[n_sc:].sum())
    sph_chunks = int(touched[:n_sc].sum())
    rows = (sph_chunks * mk.PRIM_CHUNK * mk.SPH_COLS * 4
            + tri_chunks * mk.PRIM_CHUNK * mk.TRI_COLS * 4)
    tables_bytes = (mk.table_bytes(tables) - tables.sph.nbytes
                    - tables.tri.nbytes - tables.tri_coef.nbytes + rows)
    t["flops"] = ((t["box"] + t["seg"]) * FLOP_BOX + t["tri"] * FLOP_TRI
                  + t["dist"] * FLOP_DIST)
    t["bytes"] = 24 * n + state["state_bytes"] + tables_bytes
    t["launches"] = state["launches"]
    return t


def _frame_work(cell, cfg, dev, mk, integ, scene, camera, tables) -> dict:
    """Frame 0 of seed 0 under ``cfg``, chunk by chunk as render_pixels
    draws it -> its counted work summed over its chunks."""
    import torch
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.ops.render import swizzled_pixels
    s = cell.settings
    gen = torch.Generator(device=dev).manual_seed(_frame_seed(cell, dev))
    pix = swizzled_pixels(s["width"], s["height"], device=dev)
    spp, n_pix = s["samples"], pix.shape[0]
    step = max(1, min(s["ray_chunk"] // spp, n_pix))
    starts = range(0, n_pix, step)
    seeds = torch.randint(0, 2 ** 62, (len(starts),), generator=gen,
                          device=dev).tolist()
    total = {"chunks": len(starts)}
    for lo, seed in zip(starts, seeds):
        rays = generate_pixel_rays(camera, s["width"], s["height"], spp,
                                   pix[lo:lo + step], generator=gen)
        _add(total, _chunk_work(mk, integ, scene, tables, rays, cfg, seed))
    return total


def _frame_seed(cell, dev) -> int:
    from rtbench.drivers import mesh_render
    return mesh_render.Driver(cell, SEED, dev, None).frame_seed(0)


def _kernel_names(integ, scene, tables, camera, cfg, dev) -> list:
    """The kernels one chunk of the route runs, under the profiler."""
    import torch
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.ops.render import swizzled_pixels
    from rtbench import tracing
    pix = swizzled_pixels(cfg.width, cfg.height, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rays = generate_pixel_rays(camera, cfg.width, cfg.height, cfg.samples,
                               pix[:cfg.ray_chunk // cfg.samples],
                               generator=gen)
    dt = tracing.traced(lambda: integ.integrate(scene, rays, cfg,
                                                tables=tables, seed=5),
                        lambda _: 1)
    return sorted({k.name for k in dt.kernels()})


def stream_roofline(cell=None, device="cuda:0") -> dict:
    """The frozen yardstick of ``cell`` (default: big_field.path8 as
    BENCHMARK.json has it) counted on ``device``."""
    import torch
    from cudaraytracer_tpu_torch.ops import integrators as integ
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.render import render_image
    from rtbench.drivers import _common, mesh_render
    from rtbench.inputs import big_field
    cell = cell or _cell(CELL)
    s, conf = cell.settings, cell.config
    dev = torch.device(device)
    a = big_field.scene_arrays(SEED, tuple(conf["copies"]),
                               conf["subdivisions"])
    scene = mesh_render.program_scene(a, dev)
    camera = _common.program_camera(big_field.camera_params(
        s["width"] / s["height"], conf["copies"][1], conf["subdivisions"]),
        dev)
    tables = mk.morton_tables(scene)
    base = mesh_render.render_config(s)
    pattern = re.compile(KERNEL_PATTERN)
    routes, frames = {}, {}
    for name, knobs in ROUTES:
        cfg = dataclasses.replace(base, **knobs)
        frames[name] = render_image(scene, camera, cfg, generator=torch.
                                    Generator(device=dev).manual_seed(
                                        _frame_seed(cell, dev)),
                                    tables=tables)
        work = _frame_work(cell, cfg, dev, mk, integ, scene, camera, tables)
        bound_s, by = stats.bound_seconds(work["flops"], work["bytes"],
                                          _read.PEAK_FP32, _read.PEAK_BYTES)
        names = _kernel_names(integ, scene, tables, camera, cfg, dev)
        routes[name] = {**work, "bound_ms": bound_s * 1e3, "bound_by": by,
                        "kernels_matched": [k for k in names
                                            if pattern.search(k)],
                        "kernels_other": [k for k in names
                                          if not pattern.search(k)]}
    if not all(torch.equal(frames["default"], f) for f in frames.values()):
        raise RuntimeError("the three routes' frames differ")
    if dev.type == "cuda" and not all(r["kernels_matched"]
                                      for r in routes.values()):
        raise RuntimeError("a route ran no kernel the pattern matches")
    # the lowest bound, and of equal bounds the fewest FLOPs, then bytes
    low = min(routes, key=lambda k: (routes[k]["bound_ms"],
                                     routes[k]["flops"], routes[k]["bytes"]))
    return {"kernel_pattern": KERNEL_PATTERN,
            "flops_per_item": routes[low]["flops"],
            "bytes_per_item": routes[low]["bytes"],
            "item": "frame",
            "counted": {"cell": CELL, "seed": SEED, "frame": 0,
                        "frozen": low, "frames_bit_equal": True,
                        "routes": routes}}


def main() -> int:
    import torch
    with torch.no_grad():
        out = stream_roofline()
    out["metric"] = "stream_roofline"
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
