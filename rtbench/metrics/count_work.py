"""Count, once, on the card, the work of an item for the kernel rooflines:
the tests and bytes of a frame (K1), through the program's counting
instance, at seed 0.  The readers then take the counts as constants from
``<metric>.json``, so the yardstick does not move with the program.

    python3 rtbench/metrics/count_work.py [k1_roofline]

prints one JSON object per metric: FLOPs and bytes per item and how they
were counted.  The arithmetic is a copy of ``chip_smoke.py``'s
(``launch_bound``): a test's FLOPs as the kernel writes it (slab 24,
sphere 26, triangle 46, K11's box distance 21), each launch's rays (24 B
in, 12 B out), its box and segment tables, and the rows of the chunks
whose prims it tested.  The draws' own instructions are left out of K1's
bound (its operations' time), which makes the bound lower and the share
no higher."""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

FLOP_BOX = 24
FLOP_SPHERE = 26
FLOP_TRI = 46
FLOP_DIST = 21
SEED = 0


def _cell(name):
    from rtbench import harness
    return harness.Cell(name, harness.load_json(harness.ROOT /
                                                "BENCHMARK.json"))


def _launch_work(mk, tables, o, d, cfg, seed) -> dict:
    """The counting instance of one fused launch -> its FLOPs, bytes and
    counts (``chip_smoke.launch_bound``)."""
    import torch
    dev = o.device
    n_sc = tables.sph_box.shape[0]
    counts = torch.zeros(mk.N_COUNTS, dtype=torch.int64, device=dev)
    touched = torch.zeros(max(n_sc + tables.tri_box.shape[0], 1),
                          dtype=torch.uint8, device=dev)
    work = torch.zeros(mk.N_WORK, dtype=torch.int64, device=dev)
    mk._launch_mega(tables, o.contiguous(), d.contiguous(), cfg, None, seed,
                    counts=counts, touched=touched, work=work)
    t = dict(zip(mk.COUNT_NAMES, counts.tolist()))
    t.update(zip(mk.WORK_NAMES, work.tolist()))
    sph_chunks = int(touched[:n_sc].sum())
    tri_chunks = int(touched[n_sc:].sum())
    flops = ((t["box"] + t["seg"]) * FLOP_BOX + t["sph"] * FLOP_SPHERE
             + t["tri"] * FLOP_TRI + t["dist"] * FLOP_DIST)
    rows = (sph_chunks * mk.PRIM_CHUNK * mk.SPH_COLS * 4
            + tri_chunks * mk.PRIM_CHUNK * mk.TRI_COLS * 4)
    tables_bytes = (mk.table_bytes(tables) - tables.sph.nbytes
                    - tables.tri.nbytes - tables.tri_coef.nbytes + rows)
    t["flops"] = flops
    t["bytes"] = o.shape[0] * (24 + 12) + tables_bytes
    return t


def _add(total: dict, part: dict) -> None:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def k1_roofline() -> dict:
    """One frame of one_weekend.render (frame 0 of seed 0): its chunks'
    camera rays, drawn as render_pixels draws them, each chunk through
    K1's counting instance with the chunk's own draw seed."""
    import torch
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.render import swizzled_pixels
    from rtbench.drivers import _common, render
    from rtbench.inputs import one_weekend
    cell = _cell("one_weekend.render")
    s = cell.settings
    dev = torch.device("cuda:0")
    frame_seed = render.Driver(cell, SEED, dev, None).frame_seed(0)
    scene = _common.program_scene(one_weekend.scene_arrays(SEED), dev)
    cam = _common.program_camera(
        one_weekend.camera_params(s["width"] / s["height"]), dev)
    cfg = _common.render_config(s)
    tables = mk.build_mega_tables(scene)
    pix = swizzled_pixels(s["width"], s["height"], device=dev)
    spp, n_pix = s["samples"], pix.shape[0]
    step = max(1, min(s["ray_chunk"] // spp, n_pix))
    gen = torch.Generator(device=dev).manual_seed(frame_seed)
    starts = range(0, n_pix, step)
    seeds = torch.randint(0, 2 ** 62, (len(starts),), generator=gen,
                          device=dev).tolist()
    total = {}
    for lo, seed in zip(starts, seeds):
        rays = generate_pixel_rays(cam, s["width"], s["height"], spp,
                                   pix[lo:lo + step], generator=gen)
        _add(total, _launch_work(mk, tables, rays.origin, rays.direction,
                                 cfg, seed))
    return {"kernel_pattern": "mega_path",
            "flops_per_item": total["flops"],
            "bytes_per_item": total["bytes"],
            "item": "frame",
            "counted": {"cell": "one_weekend.render", "seed": SEED,
                        "frame": 0, "launches": len(starts), **total}}


COUNTERS = {"k1_roofline": k1_roofline}


def main(argv=None) -> int:
    import torch
    names = (argv if argv is not None else sys.argv[1:]) or list(COUNTERS)
    with torch.no_grad():
        for name in names:
            out = COUNTERS[name]()
            out["metric"] = name
            out["device"] = torch.cuda.get_device_name(0)
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
