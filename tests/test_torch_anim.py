"""The skinned-animation path on the CPU: the port's skinning, keyframes,
FBX loading, recovery classification and animation driver against the JAX
package.

Inputs are built in the tests: a synthetic skinned icosphere (3 bones,
random weights made with numpy, one vertex no bone claims, 4 frames), the
ASCII FBX files of tests/test_fbx.py (which pass without the reference's
assets), and an ASCII FBX of the skinned capsule's bind pose.

Tolerances:
  * skinning and the skinned scene against JAX: 1e-5 (both blend with one
    float32 matmul; the sums may run in another order);
  * keyframe evaluation against JAX: 1e-6 (lerp), 1e-5 (slerp);
  * FBX loading: the same arrays, exactly (both packages run the same numpy
    code on the same file);
  * the mega, pallas and list pipelines: 1e-4 (lambert; the same function
    through the fused engine's plain version and two wavefront
    intersectors).
"""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest

from cudaraytracer_tpu.models import animation as janim
from cudaraytracer_tpu.models import mesh as jmesh
from cudaraytracer_tpu.models.scene import SceneBuilder as JSceneBuilder
from cudaraytracer_tpu.ops import bone_bvh as jbb
from cudaraytracer_tpu.utils import fbx_loader as jfbx
from cudaraytracer_tpu.utils import fbx_parser as jparser
from cudaraytracer_tpu_torch.apps import animate as tanimate
from cudaraytracer_tpu_torch.models import animation as tanim
from cudaraytracer_tpu_torch.models import check_scenes as cs
from cudaraytracer_tpu_torch.models import mesh as tmesh
from cudaraytracer_tpu_torch.models.scene import SceneBuilder
from cudaraytracer_tpu_torch.ops.bone_bvh import partition_by_bone
from cudaraytracer_tpu_torch.utils import fbx_loader as tfbx
from cudaraytracer_tpu_torch.utils import fbx_parser as tparser
from cudaraytracer_tpu_torch.utils import recovery as trec
from cudaraytracer_tpu_torch.utils.checkpoint import next_frame
from cudaraytracer_tpu_torch.utils.convert import skinned_mesh_from_numpy


def _synthetic_mesh():
    """A JAX SkinnedMesh: icosphere(2) on 3 bones, random weights with one
    zero row, 4 frames of random rigid-ish bone matrices."""
    rng = np.random.default_rng(11)
    pts, faces = cs.icosphere(2)
    pts = (pts * 2.0 + np.array([0.0, 1.0, -3.0])).astype(np.float32)
    w = rng.uniform(size=(len(pts), 3)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    w[5] = 0.0
    frames = 4
    mats = np.tile(np.eye(4), (frames, 3, 1, 1))
    for f in range(frames):
        for b in range(3):
            r = jfbx.euler_matrix(rng.uniform(-30, 30, 3), b)
            r[:3, 3] = rng.uniform(-0.5, 0.5, 3)
            mats[f, b] = r
    nrm = np.cross(pts[faces[:, 1]] - pts[faces[:, 0]],
                   pts[faces[:, 2]] - pts[faces[:, 0]])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return jfbx.SkinnedMesh(
        points=pts, faces=faces.astype(np.int32),
        normals=nrm.astype(np.float32), bone_names=["a", "b", "c"],
        weights=w, bone_default_t=np.zeros((3, 3), np.float32),
        bone_default_r=np.zeros((3, 3), np.float32), frame_count=frames,
        vertex_transforms=mats.astype(np.float32),
        bone_now_t=np.zeros((frames, 3, 3), np.float32),
        bone_now_r=np.zeros((frames, 3, 3), np.float32))


def test_skinning_matches_jax():
    jm = _synthetic_mesh()
    tm = skinned_mesh_from_numpy(jm)
    assert isinstance(tm, tfbx.SkinnedMesh) and tm.bone_names == jm.bone_names
    jd, td = jmesh.device_mesh(jm), tmesh.device_mesh(tm, "cpu")
    assert td.frame_count == jd.frame_count == 4
    for f in range(4):
        ref = np.asarray(jmesh.skin_points(jd.points, jd.weights,
                                           jd.vertex_transforms[f]))
        got = tmesh.skin_points(td.points, td.weights,
                                td.vertex_transforms[f]).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)
        # the vertex no bone claims stays at bind pose
        np.testing.assert_array_equal(got[5], jm.points[5])
        for a, b in zip(tmesh.skin_frame(td, f),
                        jmesh.skin_frame(jd, jnp.int32(f))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    jb, tb = JSceneBuilder(), SceneBuilder()
    for b in (jb, tb):
        m = b.materials.lambertian(color=(0.65, 0.05, 0.05))
        b.add_mesh(jm.points, jm.faces, m, normals=jm.normals,
                   reverse_winding=True)
    js, ts = jb.build(), tb.build("cpu")
    for fixed in (True, False):
        ref = jmesh.scene_with_frame(js, jd, jnp.int32(2),
                                     fixed_normals=fixed).triangles
        got = tmesh.scene_with_frame(ts, td, 2, fixed_normals=fixed).triangles
        for name in ("v0", "v1", "v2", "normal"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=1e-5, err_msg=name)
        if fixed:
            np.testing.assert_array_equal(got.normal.numpy(), jm.normals)


@pytest.mark.parametrize("slerp", [False, True])
def test_keyframes_match_jax(slerp):
    keys = [(0, (0, 0, 0), (0, 0, 0), (1, 1, 1)),
            (10, (1, 2, 3), (0, 90, 0), (2, 2, 2)),
            (5, (0.5, 0, -1), (10, 20, 30), (1, 1, 1)),
            (20, (1, 2, 3), (0, 90, 0), (2, 2, 2))]
    jt, tt = janim.make_track(keys), tanim.make_track(keys, device="cpu")
    np.testing.assert_array_equal(tt.frames.numpy(), np.asarray(jt.frames))
    frames = np.array([-3.0, 0.0, 2.5, 5.0, 7.0, 10.0, 15.5, 20.0, 27.0],
                      np.float32)
    atol = 1e-5 if slerp else 1e-6
    for fr in list(frames) + [frames]:
        ref = janim.evaluate(jt, fr, slerp=slerp)
        got = tanim.evaluate(tt, fr, slerp=slerp)
        for a, b in zip(got, ref):
            assert np.isfinite(a.numpy()).all()
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)


_QUAD_FBX = """; FBX 7.4.0 project file
FBXHeaderExtension:  {
    FBXHeaderVersion: 1003
    FBXVersion: 7400
}
Objects:  {
    Geometry: 1000, "Geometry::quad", "Mesh" {
        Vertices: *12 {
            a: 0,0,0, 1,0,0, 1,1,0, 0,1,0
        }
        PolygonVertexIndex: *4 {
            a: 0,1,2,-4
        }
    }
    Model: 2000, "Model::quadModel", "Mesh" {
        Version: 232
        Properties70:  {
            P: "Lcl Translation", "Lcl Translation", "", "A",0,0,0
        }
    }
}
Connections:  {
    C: "OO",1000,2000
    C: "OO",2000,0
}
"""


def _same_mesh(a, b):
    for name in ("points", "faces", "normals", "weights", "bone_default_t",
                 "bone_default_r", "vertex_transforms", "bone_now_t",
                 "bone_now_r"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.bone_names == b.bone_names and a.frame_count == b.frame_count


def test_fbx_loader_matches_jax(tmp_path):
    """The port's parser and loader on tests/test_fbx.py's handcrafted ASCII
    FBX (test_ascii_fbx_handcrafted), its ByPolygon quad normals
    (test_by_polygon_normals_quad_mesh), its non-finite literals and short
    Properties70 rows (test_ascii_nonfinite_literals_and_short_props), and
    an ASCII FBX of the skinned capsule's bind pose: JAX's arrays."""
    p = tmp_path / "quad_ascii.fbx"
    p.write_text(_QUAD_FBX)
    got, ref = tfbx.load_skinned_mesh(str(p)), jfbx.load_skinned_mesh(str(p))
    _same_mesh(got, ref)
    np.testing.assert_array_equal(got.faces, [[0, 1, 2], [0, 2, 3]])
    # ByPolygon normals of a fan-triangulated quad mesh
    pvi = np.asarray([0, 1, 2, ~3, 4, 5, 6, ~7], np.int64)
    tri_t, tri_j = tfbx._triangulate(pvi), jfbx._triangulate(pvi)
    for a, b in zip(tri_t, tri_j):
        np.testing.assert_array_equal(a, b)
    nrm = np.asarray([[0, 0, 1], [0, 1, 0]], np.float64)
    for mod, parser in ((tfbx, tparser), (jfbx, jparser)):
        ln = parser.FbxNode("LayerElementNormal", [], [
            parser.FbxNode("Normals", [nrm.reshape(-1)]),
            parser.FbxNode("MappingInformationType", ["ByPolygon"]),
            parser.FbxNode("ReferenceInformationType", ["Direct"])])
        geom = parser.FbxNode("Geometry", [], [ln])
        faces, first_pv, poly_id = mod._triangulate(pvi)
        out = mod._face_normals(geom, first_pv, faces, np.zeros((8, 3)),
                                poly_id)
        np.testing.assert_array_equal(out, [[0, 0, 1], [0, 0, 1],
                                            [0, 1, 0], [0, 1, 0]])
    # non-finite literals and short rows
    text = "1.5,-1.#QNAN,2.0,1.#INF,-1.#IND000"
    a, b = tparser._parse_ascii_values(text), jparser._parse_ascii_values(text)
    np.testing.assert_array_equal(np.array(a), np.array(b))
    assert len(a) == 5 and np.isnan(a[1]) and np.isinf(a[3])
    for parser in (tparser, jparser):
        p70 = parser.FbxNode("Properties70", [], [
            parser.FbxNode("P", ["Lcl Scaling", "Lcl Scaling", "", "A", 5.0]),
            parser.FbxNode("P", ["Lcl Translation", "Lcl Translation", "",
                                 "A", 1.0, 2.0])])
        node = parser.FbxNode("Model", [], [p70])
        np.testing.assert_allclose(parser.get_vec3_prop(node, "Lcl Scaling"),
                                   [5.0, 5.0, 5.0])
        np.testing.assert_allclose(parser.get_vec3_prop(
            node, "Lcl Translation", (9.0, 9.0, 9.0)), [1.0, 2.0, 9.0])
    # the capsule's bind pose, written as ASCII FBX
    cap = cs.skinned_capsule()
    path = str(tmp_path / "capsule.fbx")
    cs.write_ascii_fbx(path, cap.points, cap.faces, frames=3)
    got, ref = tfbx.load_skinned_mesh(path), jfbx.load_skinned_mesh(path)
    _same_mesh(got, ref)
    np.testing.assert_array_equal(got.points, cap.points)
    np.testing.assert_array_equal(got.faces, cap.faces)
    assert got.frame_count == 3


def test_euler_matrix_and_trs_match_jax():
    for order in range(6):
        np.testing.assert_array_equal(tfbx.euler_matrix((30, 40, 50), order),
                                      jfbx.euler_matrix((30, 40, 50), order))
    m = tfbx.euler_matrix((10, 20, 30), 0)
    m[:3, 3] = (1, 2, 3)
    for a, b in zip(tfbx.matrix_to_trs(m), jfbx.matrix_to_trs(m)):
        np.testing.assert_array_equal(a, b)


def test_recovery_classifies_cuda_errors():
    sticky = ["CUDA error: an illegal memory access was encountered",
              "CUDA error: unspecified launch failure",
              "CUDA error: uncorrectable ECC error encountered",
              "CUDA error: device-side assert triggered",
              "megakernel launch failed: cudaErrorIllegalAddress"]
    transient = ["CUDA error: all CUDA-capable devices are busy or "
                 "unavailable", "NCCL: connection reset by peer",
                 "Watchdog caught collective operation timeout"]
    for text in sticky:
        err = RuntimeError(text)
        assert trec.is_sticky_cuda_error(err)
        assert not trec.is_transient_device_error(err)
    for text in transient:
        assert trec.is_transient_device_error(RuntimeError(text))
    assert not trec.is_transient_device_error(ValueError(transient[0]))
    assert not trec.is_transient_device_error(RuntimeError("shape mismatch"))
    # a sticky error re-raises at once, a transient one is retried
    calls, slept = [], []

    def step(text):
        calls.append(text)
        raise RuntimeError(text)

    with pytest.raises(RuntimeError, match="illegal memory"):
        trec.retry_transient(lambda: step(sticky[0]), retries=3,
                             sleep=slept.append)
    assert len(calls) == 1 and not slept
    calls.clear()
    with pytest.raises(trec.RetriesExhausted):
        trec.retry_transient(lambda: step(transient[0]), retries=2,
                             backoff_s=1.0, sleep=slept.append)
    assert len(calls) == 3 and slept == [1.0, 2.0]


def _args(tmp_path, pipeline, *extra):
    return ["--cpu", "--width", "16", "--height", "8", "--samples", "1",
            "--frames", "2", "--pipeline", pipeline, "--out",
            str(tmp_path / pipeline), "--csv", str(tmp_path / f"{pipeline}.csv"),
            *extra]


def test_animate_pipelines_on_cpu(tmp_path):
    """apps/animate.py on an ASCII FBX of the capsule's bind pose: main()
    writes the CSV and a PNG per frame for mega, pallas, list, bvh and
    fused, whose frames agree; bonebvh on that unskinned file raises the
    empty-forest error, as the JAX package's apps/animate.py does, and on
    the skinned capsule drops exactly the triangles no bone claims; a
    missing file raises FileNotFoundError, and --resume skips rendered
    frames."""
    cap = cs.skinned_capsule()
    path = str(tmp_path / "capsule.fbx")
    cs.write_ascii_fbx(path, cap.points, cap.faces, frames=3)
    images = {}
    for pipeline in ("mega", "pallas", "list", "bvh", "fused"):
        args = _args(tmp_path, pipeline, "--fbx", path)
        assert tanimate.main(args) == 0
        assert sorted(os.listdir(tmp_path / pipeline)) == [
            "picture_0.png", "picture_1.png"]
        with open(tmp_path / f"{pipeline}.csv") as f:
            rows = [r for r in csv.reader(f) if not r[0].startswith("#")]
        assert rows[0] == ["frame", "rendering", "update", "build"]
        assert rows[1][:3] == ["", "", ""] and float(rows[1][3]) >= 0.0
        assert [r[0] for r in rows[2:]] == ["0", "1"]
        assert all(float(r[1]) > 0.0 for r in rows[2:])
        # update: the skinning (and the refit on bvh); 0 on list and fused
        assert all((float(r[2]) > 0.0) == (pipeline not in ("list", "fused"))
                   for r in rows[2:])
        run = tanimate.animate(tanimate.load_mesh(path),
                               tanimate.parse_args(args + ["--no-png"]))
        assert run.frames == [0, 1] and run.image.shape == (8, 16, 3)
        images[pipeline] = run.image
    assert (images["mega"][..., 0] > images["mega"][..., 1]).mean() > 0.1
    for pipeline in ("pallas", "list", "bvh", "fused"):
        np.testing.assert_allclose(images[pipeline], images["mega"],
                                   atol=1e-4)
    # the animated capsule: frames differ, the update is timed
    run = tanimate.animate(cap, tanimate.parse_args(
        _args(tmp_path, "mega", "--begin-frame", "29", "--no-png", "--csv",
              str(tmp_path / "anim.csv"))))
    assert run.frames == [29, 30] and all(u > 0.0 for u in run.update)
    # the unskinned file's mesh carries all-zero weights on one bone: the
    # JAX package's forest build refuses it, and so does the port's
    jm = jfbx.load_skinned_mesh(path)
    with pytest.raises(ValueError, match="empty bone forest"):
        jbb.build_bone_forest(*(jm.points[jm.faces[:, k]] for k in (2, 1, 0)),
                              jm.weights, jm.faces)
    with pytest.raises(ValueError, match="empty bone forest"):
        tanimate.main(_args(tmp_path, "bonebvh", "--fbx", path))
    run = tanimate.animate(cap, tanimate.parse_args(
        _args(tmp_path, "bonebvh", "--begin-frame", "29", "--no-png",
              "--csv", str(tmp_path / "bone.csv"))))
    assert run.frames == [29, 30] and all(u > 0.0 for u in run.update)
    assert run.dropped == int((partition_by_bone(cap.weights, cap.faces)
                               < 0).sum())
    with pytest.raises(FileNotFoundError, match="--fbx"):
        tanimate.main(_args(tmp_path, "mega", "--fbx",
                            str(tmp_path / "missing.fbx")))
    assert next_frame(str(tmp_path / "mega")) == 2
    assert tanimate.main(_args(tmp_path, "mega", "--fbx", path, "--frames",
                               "3", "--resume")) == 0
    assert next_frame(str(tmp_path / "mega")) == 3
    with open(tmp_path / "mega.csv") as f:
        frames = [r[0] for r in csv.reader(f) if r and r[0].isdigit()]
    assert frames == ["0", "1", "2"]
    assert tanimate.frame_seed(1) != tanimate.frame_seed(2)
