"""The multi-rank dry run (the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``, __graft_entry__.py:40-166).

``dryrun_multichip(n, device)`` spawns n ranks on a ('dp', 'tp') mesh (tp =
2 when n is even) and runs, on a production-shaped scene (checker ground,
dielectric, metal, an image-textured sphere and rect light, a 288-triangle
wavy sheet, a runtime-TRS sphere and triangle) at 96x48x1, path depth 6:
the wavefront render (prims over tp) and the fused render (``engine=
'mega'``, tables replicated) under the mesh on one injected stream, the
sample-parallel render, and one ``mega_diff`` fit step with per-bounce
gradient sync on the centers, albedos and mesh vertices.  The asserts of
the JAX record are kept:
  * mega against the wavefront under the mesh: max abs difference below
    3e-4 (same rays, same stream);
  * sample-parallel against the mean of the members' single-process
    renders: below 3e-4;
  * a finite loss and finite parameters;
and every rank must return the same frames and the same step.

    python -m cudaraytracer_tpu_torch.parallel.dryrun 4 [--cpu]
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

TOL = 3e-4


def dryrun_scene(device):
    """(scene, camera) of the dry run (__graft_entry__.py:80-128)."""
    from ..core.camera import make_camera
    from ..models.scene import SceneBuilder
    b = SceneBuilder()
    m = b.materials
    img_tex = m.textures.image(
        (np.arange(192) * 77 % 256).astype(np.uint8).reshape(8, 8, 3))
    b.add_sphere((0, -100.5, -3), 100.0,
                 m.lambertian(m.textures.checker((0.8, 0.8, 0.0),
                                                 (0.1, 0.1, 0.1))))
    b.add_sphere((-1.6, 0, -3), 0.5, m.dielectric(1.5))
    b.add_sphere((1.6, 0, -3), 0.5, m.metal((0.8, 0.6, 0.2), 0.3))
    b.add_sphere((0, 0.9, -3), 0.45, m.lambertian(tex_id=img_tex))
    b.add_rect(m.diffuse_light(tex_id=img_tex), position=(0, 2.2, -3),
               rotation=(90, 0, 0), scale=(2.5, 2.5, 1.0))
    red = m.lambertian(color=(0.8, 0.2, 0.2))
    n = 12
    X, Z = np.meshgrid(np.linspace(-1.2, 1.2, n + 1),
                       np.linspace(-3.8, -2.2, n + 1))
    Y = -0.45 + 0.12 * np.sin(X * 4.0) * np.cos(Z * 3.0)
    P = np.stack([X, Y, Z], axis=-1).astype(np.float32)
    v0, v1 = P[:-1, :-1].reshape(-1, 3), P[:-1, 1:].reshape(-1, 3)
    v2, v3 = P[1:, :-1].reshape(-1, 3), P[1:, 1:].reshape(-1, 3)
    tris = np.concatenate([np.stack([v0, v1, v3], 1),
                           np.stack([v0, v3, v2], 1)])
    nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    nrm[nrm[:, 1] < 0] *= -1.0
    for t, nn in zip(tris, nrm):
        b.add_triangle(t[0], t[1], t[2], red, normal=nn)
    b.add_sphere((-0.8, 0.35, -2.6), 0.3, m.metal((0.7, 0.7, 0.9), 0.0),
                 rotation=(0, 30, 0), scale=(1.0, 0.6, 1.0))
    b.add_triangle((-0.3, 0, 0), (0.3, 0, 0), (0, 0.5, 0), red,
                   position=(0.8, 0.2, -2.5), rotation=(10, -25, 5),
                   scale=(1.2, 1.0, 1.0))
    scene = b.build(device)
    assert (scene.n_triangles >= 288 and scene.n_t_spheres
            and scene.n_t_triangles and scene.textures.images.shape[0] > 1)
    camera = make_camera((0, 0.6, 0.6), (0, 0.2, -3), (0, 1, 0), 55.0, 2.0,
                         0.0, 4.0, device=device)
    return scene, camera


def dryrun_config():
    """96x48x1, path depth 6, no gamma; the sphere cull on camera sweeps
    only, so the sharded and single-process sweeps both keep builder
    order."""
    from ..config import RenderConfig
    return RenderConfig(width=96, height=48, samples=1, max_depth=6,
                        integrator="path", gamma=False, ray_chunk=1 << 20,
                        wavefront_sphere_cull="primary")


def dryrun_rank(device, n_devices: int) -> dict:
    """The dry run's body on one rank (called by ``spawn``)."""
    from ..core.camera import generate_pixel_rays
    from ..ops.integrators import stream_from_generator
    from ..ops.render import (finish_pixels, render_pixels,
                              swizzled_pixels, sweep_intersector_pair)
    from .mesh import make_mesh
    from .render import (member_generator, render_image_sample_sharded,
                         render_image_sharded)
    from .train import make_fit_step

    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices, tp=tp)
    scene, camera = dryrun_scene(device)
    cfg = dryrun_config()
    w, h, spp = cfg.width, cfg.height, cfg.samples

    # the wavefront (prims over tp) and the fused engine (tables
    # replicated) under the mesh, on the same injected rays and stream
    gen = torch.Generator(device=device).manual_seed(0)
    rays = generate_pixel_rays(camera, w, h, spp,
                               swizzled_pixels(w, h, device=device),
                               generator=gen)
    stream = stream_from_generator(gen, w * h * spp, cfg.max_depth, device)
    img = render_image_sharded(scene, camera, cfg, mesh, rays=rays,
                               samples=stream)
    img_m = render_image_sharded(scene, camera,
                                 dataclasses.replace(cfg, engine="mega"),
                                 mesh, rays=rays, samples=stream)
    assert img.shape == (h, w, 3) and bool(torch.isfinite(img_m).all())
    dm = float((img_m - img).abs().max())
    assert dm < TOL, f"mega vs wavefront diverge under the mesh: {dm}"

    # sample-parallel against the mean of the members' single-process
    # renders (the same generators, gamma and clip after the mean)
    img_sp = render_image_sample_sharded(scene, camera, cfg, mesh, seed=2)
    cfg_lin = dataclasses.replace(cfg, gamma=False, clip=False)
    acc = 0.0
    for member in range(mesh.dp):
        acc = acc + render_pixels(
            scene, camera, cfg_lin, None,
            member_generator(2, member, device),
            intersect_fn=sweep_intersector_pair(cfg))
    ref_sp = finish_pixels(acc / mesh.dp, cfg).reshape(h, w, 3)
    ds = float((img_sp - ref_sp).abs().max())
    assert ds < TOL, f"sample-parallel vs single-process diverge: {ds}"

    # one mega_diff fit step, per-bounce gradient sync over the mesh
    params = {"centers": scene.spheres.center.clone().requires_grad_(),
              "albedo": scene.textures.color0.clone().requires_grad_(),
              "tri_v": tuple(x.clone().requires_grad_() for x in (
                  scene.triangles.v0, scene.triangles.v1,
                  scene.triangles.v2))}
    step = make_fit_step(scene, camera,
                         dataclasses.replace(cfg, engine="mega_diff"),
                         lr=0.1, mesh=mesh, overlap_grads=True)
    loss, new = step(params, img.reshape(-1, 3),
                     member_generator(1, mesh.rank, device))
    assert bool(torch.isfinite(loss)), f"non-finite loss {float(loss)}"
    leaves = [new["centers"], new["albedo"], *new["tri_v"]]
    assert all(bool(torch.isfinite(x).all()) for x in leaves)
    return {"mesh": mesh.shape, "mega_vs_wavefront": dm,
            "sample_parallel_vs_single": ds, "loss": float(loss),
            "img": img.cpu(), "img_m": img_m.cpu(), "img_sp": img_sp.cpu(),
            "params": [x.detach().cpu() for x in leaves],
            "n_tri": scene.n_triangles,
            "n_trs": scene.n_t_spheres + scene.n_t_triangles,
            "images": scene.textures.images.shape[0] - 1}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Spawn ``n_devices`` ranks on ``device`` (None: the CUDA card, which
    they share through gloo when there are more ranks than cards) and run
    ``dryrun_rank`` on each; every rank must agree.  Returns rank 0's
    record."""
    from ..core.device import resolve_device
    from .mesh import spawn
    device = resolve_device(device)
    outs = spawn(dryrun_rank, n_devices, (n_devices,), device=device,
                 threads=1 if device.type == "cpu" else 0)
    first = outs[0]
    for r, out in enumerate(outs[1:], 1):
        for key in ("img", "img_m", "img_sp"):
            assert torch.equal(out[key], first[key]), (
                f"rank {r}'s {key} differs from rank 0's")
        assert out["loss"] == first["loss"], f"rank {r}'s loss differs"
        for a, b in zip(out["params"], first["params"]):
            assert torch.equal(a, b), f"rank {r}'s step differs"
    cfg = dryrun_config()
    print(f"dryrun_multichip({n_devices}): mesh={first['mesh']} "
          f"{cfg.width}x{cfg.height} depth={cfg.max_depth} "
          f"n_tri={first['n_tri']} n_trs={first['n_trs']} "
          f"images={first['images']} loss={first['loss']:.6f} "
          f"mega-wavefront {first['mega_vs_wavefront']:.3g} "
          f"sample-parallel {first['sample_parallel_vs_single']:.3g} OK",
          flush=True)
    return first


if __name__ == "__main__":
    args = sys.argv[1:]
    dryrun_multichip(int(args[0]) if args and args[0] != "--cpu" else 4,
                     "cpu" if "--cpu" in args else None)
