"""Kernel mode K12 (cfg.mega_mxu) on the CPU: the port's coefficient rows and
its bilinear triangle sweep (the plain version) against the JAX package.

The scene is tests/test_megakernel.py's MXU terrain (:273-346): 10,368
triangles, above the table-resident size, and a metal sphere, with 512 rays
cast from above and an injected scatter stream made with numpy, under both
quirk profiles (the reference profile runs the d.n block and the no-t-clip
window).

Tolerances:
  * tri_coef, unpacked into JAX's dense rows (dense_tri_coef): JAX's first
    10 lanes in the same row order, each within 2
    ulps of the magnitude of the products its formula sums (|a1 b2| + |a2
    b1| for a cross product's component; for -v0.n2 the sum of |v0_k| (|n2_k|
    + that of n2_k)), and equal where it copies an input: XLA:CPU contracts
    the cross products into FMAs, PyTorch does not, which moves a component
    that cancels by up to 1 ulp of its products (measured: 1.0), many ulps of
    the small result;
  * the first hit's t of the bilinear sweep against Moller-Trumbore's: 1e-5
    relative (measured 3.5e-7), the same winners;
  * the plain MXU render against JAX's brute-force ``integ.trace_path``
    (Moller-Trumbore): at most max(2, n/500) rays over 1e-3, JAX's own limit
    for its MXU sweep, since the bilinear forms round otherwise;
  * the phased driver against the monolithic render under MXU: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaraytracer_tpu.config import Quirks as JQuirks
from cudaraytracer_tpu.config import RenderConfig as JConfig
from cudaraytracer_tpu.core.rays import make_rays as jmake_rays
from cudaraytracer_tpu.ops import integrators as jinteg
from cudaraytracer_tpu.ops import megakernel as jmk
from cudaraytracer_tpu_torch.config import check_supported
from cudaraytracer_tpu_torch.ops import megakernel as tmk
from cudaraytracer_tpu_torch.ops.sweeps import triangle_candidates_t
from _torch_threads import one_intra_op_thread  # noqa: F401
from test_torch_megakernel import _np_tree
from test_torch_stream import N_RAYS, _cfg, _stream, _streamed, _trays


def _mxu_tables(orders=None):
    _, ts, _, _, mo = _streamed("terrain")
    return ts, tmk.build_mega_tables(ts, *(orders or mo), mxu=True)


def test_tri_coef_matches_jax():
    js, ts, _, _, (tri_o, sph_o) = _streamed("terrain")
    jt = _np_tree(jmk.build_mega_tables(js, tri_order=tri_o,
                                        sph_order=sph_o, mxu=True))
    tt = tmk.build_mega_tables(ts, tri_o, sph_o, mxu=True)
    t_pad = tt.tri.shape[0]
    assert tt.tri_coef.shape == (t_pad // tmk.SUPER_T * tmk.N_COEF,
                                 tmk.SUPER_T)
    got = tmk.dense_tri_coef(tt.tri_coef).numpy()
    assert got.shape == (tmk.N_Q * t_pad, tmk.N_FEAT)
    assert got.shape[0] == jt.tri_coef.shape[0]
    ref = jt.tri_coef[:, :tmk.N_FEAT]
    mag = _coef_magnitudes(ts, tri_o, tt.tri.shape[0])
    err = np.abs(got.astype(np.float64) - ref)
    assert (err <= 2 * np.spacing(mag.astype(np.float32))).all()
    assert (err[mag == 0] == 0).all()
    # only the terms Q_TERMS names are non-zero
    blocks = got.reshape(-1, tmk.N_Q, tmk.SUPER_T, tmk.N_FEAT)
    for q, terms in enumerate(tmk.Q_TERMS):
        off = [k for k in range(tmk.N_FEAT) if k not in terms]
        assert not blocks[:, q][..., off].any()
    # without mxu=True a placeholder, as JAX builds
    plain = tmk.build_mega_tables(ts, tri_o, sph_o)
    assert plain.tri_coef.shape == (0, tmk.SUPER_T)
    # 96 bytes a triangle: the 22 non-zero coefficients and 2 zeros
    assert (tmk.table_bytes(tt) - tmk.table_bytes(plain)
            == tt.tri_coef.nbytes == 96 * t_pad)


def _dense_rows(v0, e1, e2, nrm, mult):
    """The dense float32[N_Q * T_pad, N_FEAT] coefficient rows that the
    port built before the packed layout: per triangle each quantity's
    coefficients on the 10 features, zeros included, per SUPER_T triangles
    one block per quantity."""
    def cross(a, b):
        return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)

    n2 = cross(e1, e2)
    z1, z3 = torch.zeros_like(v0[:, :1]), torch.zeros_like(v0)
    v0_n2 = (v0[:, 0] * n2[:, 0] + v0[:, 1] * n2[:, 1]
             + v0[:, 2] * n2[:, 2])[:, None]
    q = torch.stack([
        torch.cat([-n2, z3, z3, z1], 1),
        torch.cat([z3, n2, z3, -v0_n2], 1),
        torch.cat([cross(v0, e2), z3, -e2, z1], 1),
        torch.cat([-cross(v0, e1), z3, e1, z1], 1),
        torch.cat([nrm, z3, z3, z1], 1)], 1)
    q = tmk.pad_rows(q, mult)
    return (q.reshape(-1, tmk.SUPER_T, tmk.N_Q, tmk.N_FEAT)
            .transpose(1, 2).reshape(-1, tmk.N_FEAT))


def test_tri_coef_unpacks_to_the_dense_rows():
    """The packed coefficients hold exactly the dense rows' non-zero
    values: unpacked, they equal the dense rows bit for bit, the two pad
    planes are zero, and a super's coefficient k of its 256 triangles is
    one contiguous plane."""
    _, ts, _, _, (tri_o, _) = _streamed("terrain")
    tt = tmk.build_mega_tables(ts, tri_o, mxu=True)
    tr = ts.triangles
    o = torch.as_tensor(tri_o).long()
    v0, v1, v2 = tr.v0[o], tr.v1[o], tr.v2[o]
    dense = _dense_rows(v0, v1 - v0, v2 - v0, tr.normal[o], tmk.SEG_T)
    got = tmk.dense_tri_coef(tt.tri_coef)
    assert torch.equal(got, dense)
    planes = tt.tri_coef.view(-1, tmk.N_COEF, tmk.SUPER_T)
    assert not planes[:, tmk.Q_OFF[tmk.Q_DN] + 3:].any()
    # the super's a-coefficient on d_y: dense block Q_A, feature 1
    s = 7
    blocks = dense.view(-1, tmk.N_Q, tmk.SUPER_T, tmk.N_FEAT)
    assert torch.equal(planes[s, tmk.Q_OFF[tmk.Q_A] + 1],
                       blocks[s, tmk.Q_A, :, 1])


def _coef_magnitudes(ts, order, t_pad):
    """float64[N_Q * t_pad, N_FEAT]: per coefficient the magnitude of the
    products its formula sums (0 where it copies an input), in tri_coef's
    row order."""
    tr = ts.triangles
    v0, v1, v2 = (x.numpy()[np.asarray(order)] for x in (tr.v0, tr.v1,
                                                          tr.v2))
    e1, e2 = (v1 - v0).astype(np.float64), (v2 - v0).astype(np.float64)
    v0 = v0.astype(np.float64)

    def cross_mag(a, b):
        return np.stack([abs(a[:, i] * b[:, j]) + abs(a[:, j] * b[:, i])
                         for i, j in ((1, 2), (2, 0), (0, 1))], 1)

    m_n2 = cross_mag(e1, e2)
    m_9 = (abs(v0) * (abs(np.cross(e1, e2)) + m_n2)).sum(1, keepdims=True)
    z3, z1 = np.zeros_like(m_n2), np.zeros_like(m_9)
    mag = np.stack([np.concatenate(q, 1) for q in (
        (m_n2, z3, z3, z1), (z3, m_n2, z3, m_9),
        (cross_mag(v0, e2), z3, z3, z1), (cross_mag(v0, e1), z3, z3, z1),
        (z3, z3, z3, z1))], 1)
    mag = np.concatenate([mag, np.repeat(mag[-1:], t_pad - len(mag), 0)])
    return (mag.reshape(-1, tmk.SUPER_T, tmk.N_Q, tmk.N_FEAT)
            .transpose(0, 2, 1, 3).reshape(-1, tmk.N_FEAT))


@pytest.mark.parametrize("profile", ["fixed", "reference"])
def test_mxu_render_matches_jax_trace_path(profile):
    """The plain MXU render (K12) against JAX's brute-force wavefront on
    the same rays and injected stream; the phased driver bit-equal to it."""
    js, ts, o, d, _ = _streamed("terrain")
    _, tables = _mxu_tables()
    ball, prob, stream = _stream()
    jcfg = JConfig(width=16, height=32, samples=1, max_depth=ball.shape[0] - 1,
                   quirks=getattr(JQuirks, profile)())
    ref = np.asarray(jinteg.trace_path(
        js, jmake_rays(jnp.asarray(o), jnp.asarray(d)), jax.random.key(5),
        jcfg, samples=jinteg.SampleStream(jnp.asarray(ball),
                                          jnp.asarray(prob))))
    cfg = _cfg(profile, mega_mxu=True)
    check_supported(cfg)
    got = tmk.trace_path_mega(ts, _trays(o, d), cfg, tables=tables,
                              samples=stream).numpy()
    assert ref.mean() > 0.01 and np.isfinite(got).all()
    n_bad = int((np.abs(got - ref).max(axis=1) > 1e-3).sum())
    assert n_bad <= max(2, N_RAYS // 500), n_bad
    # the first hit: the bilinear forms round otherwise than
    # Moller-Trumbore, the winners are the same
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    t_b, row_b = tmk._tri_sweep_mxu_plain(
        tables, ot, dt, torch.full((N_RAYS,), tmk.BIG), cfg)
    tr = tables.tri
    t_m, row_m = triangle_candidates_t(
        ot, dt, tr[:, 0:3], tr[:, 3:6], tr[:, 6:9], tr[:, 9:12],
        float(np.float32(cfg.t_min)), float(np.float32(cfg.t_max)),
        cfg.quirks).min(dim=1)
    hit = t_m < tmk.BIG_CUT
    assert bool(hit.any()) and torch.equal(t_b < tmk.BIG_CUT, hit)
    assert torch.equal(row_b[hit], row_m[hit])
    rel = ((t_b - t_m).abs() / t_m.abs())[hit]
    assert float(rel.max()) <= 1e-5 and bool((rel > 0).any())
    phased = tmk.trace_path_mega_phased(ts, _trays(o, d), cfg, tables=tables,
                                        compact_every=2, samples=stream,
                                        octants=True)
    np.testing.assert_array_equal(phased.numpy(), got)


def test_mxu_drivers_build_their_tables_and_match(monkeypatch):
    """With no tables given, the fused entry points build Morton-free
    tables with the coefficients (JAX :1805, :1908, :2754): the monolithic
    render, the compact driver and select_mega's phased route (octants,
    under compact_auto with its threshold lowered) agree bit for bit, under
    counter draws."""
    _, ts, o, d, _ = _streamed("terrain")
    cfg = _cfg(mega_mxu=True)
    want = tmk.trace_path_mega(ts, _trays(o, d), cfg, seed=9)
    got = tmk.trace_path_mega_compact(ts, _trays(o, d), cfg,
                                      primary_steps=1, seed=9)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    monkeypatch.setattr(tmk, "AUTO_COMPACT_TRIS", 1 << 10)
    assert cfg.compact_auto
    got = tmk.select_mega(ts, _trays(o, d), cfg, seed=9)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_mxu_routing(monkeypatch):
    """K12 runs only on streamed triangles, never while recording winners,
    with the shells forced off (also the 8 of select_mega's route); tables
    without coefficients raise, naming mxu=True."""
    ts, tables = _mxu_tables()
    cfg = _cfg(mega_mxu=True, mega_f2b_shells=8)
    assert tmk.launch_modes(tables, cfg, False) == (False, True, 0)
    assert tmk.launch_modes(tables, cfg, True) == (False, False, 8)
    off = dataclasses.replace(cfg, mega_mxu=False)
    assert tmk.launch_modes(tables, off, False) == (False, False, 8)
    plain = tmk.build_mega_tables(ts)
    with pytest.raises(ValueError, match="mxu=True"):
        tmk.launch_modes(plain, cfg, False)
    _, _, o, d, _ = _streamed("terrain")
    with pytest.raises(ValueError, match="mxu=True"):
        tmk.trace_path_mega(ts, _trays(o, d), cfg, tables=plain, seed=1)
    # a resident scene never takes K12, with or without coefficients
    from cudaraytracer_tpu_torch.models import presets as tpresets
    small, _ = tpresets.random_spheres(device="cpu")
    assert not tmk.mxu_wanted(small, cfg)
    assert tmk.launch_modes(tmk.build_mega_tables(small, mxu=True), cfg,
                            False)[1] is False
    # select_mega's compact_auto route forces 8 shells; K12 turns them off
    seen = []

    def trace(tables, o, d, cfg, stream, seed, want_winners=False,
              window=tmk.WHOLE):
        seen.append(tmk.launch_modes(tables, cfg, want_winners))
        return tmk.trace_path_mega_plain(tables, tmk.Rays(o, d, o[:0, 0]),
                                         cfg, stream, seed, want_winners,
                                         window)

    monkeypatch.setattr(tmk, "AUTO_COMPACT_TRIS", 1 << 10)
    monkeypatch.setattr(tmk, "_trace", trace)
    auto = dataclasses.replace(cfg, mega_f2b_shells=0)
    tmk.select_mega(ts, _trays(o[:64], d[:64]), auto, tables=tables, seed=3)
    assert seen and all(m == (False, True, 0) for m in seen), seen


def test_mega_diff_records_without_mxu():
    """engine='mega_diff' under mega_mxu: a forward that records winners
    (gradients asked) runs the Moller-Trumbore sweep on tables built
    without coefficients; one without gradients takes K12, as JAX's
    primal does."""
    _, ts, o, d, _ = _streamed("terrain")
    n = 128
    rays = _trays(o[:n], d[:n])
    ball, prob, _ = _stream(n=n)
    from cudaraytracer_tpu_torch.ops.integrators import SampleStream
    stream = SampleStream(torch.from_numpy(ball), torch.from_numpy(prob))
    cfg = dataclasses.replace(_cfg(mega_mxu=True), engine="mega_diff")
    mxu = tmk.trace_path_mega(ts, rays, cfg, samples=stream)
    mt = tmk.trace_path_mega(ts, rays, dataclasses.replace(cfg, mega_mxu=False),
                             samples=stream)
    scene = ts._replace(triangles=ts.triangles._replace(
        v0=ts.triangles.v0.clone().requires_grad_()))
    rec = tmk.trace_path_mega_diff(scene, rays, cfg, samples=stream)
    assert rec.requires_grad
    np.testing.assert_array_equal(rec.detach().numpy(), mt.numpy())
    with torch.no_grad():
        prim = tmk.trace_path_mega_diff(scene, rays, cfg, samples=stream)
    np.testing.assert_array_equal(prim.numpy(), mxu.numpy())
