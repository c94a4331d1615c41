"""The "Ray Tracing in One Weekend" final scene (Shirley, "Ray Tracing in
One Weekend", section 13), as plain numpy arrays that both the program and
the reference build their scenes from.

A frozen copy of the layout of ``presets.random_spheres`` (n = 22, its
layout seed 7): the ground sphere on a checker, a 22 x 22 grid of small
spheres (lambertian, metal and dielectric in the proportions 0.8 / 0.15 /
0.05) with the cell that would touch the big metal sphere left out, and
the three big spheres.  The layout (every centre, radius and material
kind) is that of seed 7 for every benchmark seed, so every seed has the
same work; ``seed`` draws the small spheres' colours and fuzz.
"""

from __future__ import annotations

import numpy as np

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
CONSTANT, CHECKER = 0, 1
LAYOUT_SEED = 7
GRID = 22


def scene_arrays(seed: int) -> dict:
    """The scene as flat arrays:

    - ``tex_kind`` int32[K], ``tex_c0`` / ``tex_c1`` float32[K, 3]: the
      textures (texture 0 the ground's checker, then one constant colour
      per lambertian in the order the spheres are added);
    - ``mat_kind`` int32[M], ``mat_tex`` int32[M], ``mat_albedo``
      float32[M, 3], ``mat_fuzz`` float32[M], ``mat_ref_idx`` float32[M];
    - ``center`` float32[S, 3], ``radius`` float32[S], ``sph_mat`` int32[S].
    """
    layout = np.random.default_rng(LAYOUT_SEED)
    colours = np.random.default_rng(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(seed) >> 32, 0x0E1]))
    tex_kind, tex_c0, tex_c1 = [], [], []
    mat = {"kind": [], "tex": [], "albedo": [], "fuzz": [], "ref_idx": []}
    spheres = {"center": [], "radius": [], "mat": []}

    def texture(kind, c0, c1=(0.0, 0.0, 0.0)):
        tex_kind.append(kind)
        tex_c0.append(np.asarray(c0, np.float32))
        tex_c1.append(np.asarray(c1, np.float32))
        return len(tex_kind) - 1

    def material(kind, tex=0, albedo=(0.0, 0.0, 0.0), fuzz=0.0, ref_idx=1.0):
        mat["kind"].append(kind)
        mat["tex"].append(tex)
        mat["albedo"].append(np.asarray(albedo, np.float32))
        mat["fuzz"].append(min(float(fuzz), 1.0))
        mat["ref_idx"].append(float(ref_idx))
        return len(mat["kind"]) - 1

    def sphere(center, radius, m):
        spheres["center"].append(np.asarray(center, np.float32))
        spheres["radius"].append(float(radius))
        spheres["mat"].append(m)

    ground = material(LAMBERTIAN, texture(CHECKER, (0.2, 0.3, 0.1),
                                          (0.9, 0.9, 0.9)))
    sphere((0, -1000, 0), 1000.0, ground)
    half = GRID // 2
    for a in range(-half, half):
        for c in range(-half, half):
            choose = layout.uniform()
            cen = np.array([a + 0.9 * layout.uniform(), 0.2,
                            c + 0.9 * layout.uniform()])
            if np.linalg.norm(cen - np.array([4, 0.2, 0])) <= 0.9:
                continue
            if choose < 0.8:
                layout.uniform(size=6)          # the preset's albedo draws
                albedo = (colours.uniform(size=3) * colours.uniform(size=3))
                sphere(cen, 0.2, material(LAMBERTIAN,
                                          texture(CONSTANT, albedo)))
            elif choose < 0.95:
                layout.uniform(size=4)          # the preset's albedo, fuzz
                albedo = 0.5 * (1 + colours.uniform(size=3))
                sphere(cen, 0.2, material(METAL, albedo=albedo,
                                          fuzz=0.5 * colours.uniform()))
            else:
                sphere(cen, 0.2, material(DIELECTRIC, ref_idx=1.5))
    sphere((0, 1, 0), 1.0, material(DIELECTRIC, ref_idx=1.5))
    sphere((-4, 1, 0), 1.0, material(LAMBERTIAN,
                                     texture(CONSTANT, (0.4, 0.2, 0.1))))
    sphere((4, 1, 0), 1.0, material(METAL, albedo=(0.7, 0.6, 0.5), fuzz=0.0))
    return {
        "tex_kind": np.asarray(tex_kind, np.int32),
        "tex_c0": np.stack(tex_c0).astype(np.float32),
        "tex_c1": np.stack(tex_c1).astype(np.float32),
        "mat_kind": np.asarray(mat["kind"], np.int32),
        "mat_tex": np.asarray(mat["tex"], np.int32),
        "mat_albedo": np.stack(mat["albedo"]).astype(np.float32),
        "mat_fuzz": np.asarray(mat["fuzz"], np.float32),
        "mat_ref_idx": np.asarray(mat["ref_idx"], np.float32),
        "center": np.stack(spheres["center"]).astype(np.float32),
        "radius": np.asarray(spheres["radius"], np.float32),
        "sph_mat": np.asarray(spheres["mat"], np.int32),
    }


def camera_params(aspect: float) -> dict:
    """The preset's camera (``make_camera`` arguments)."""
    return {"lookfrom": (13.0, 2.0, 3.0), "lookat": (0.0, 0.0, 0.0),
            "vup": (0.0, 1.0, 0.0), "vfov": 20.0, "aspect": aspect,
            "aperture": 0.0, "focus_dist": 10.0}
