"""K10's window over the path state's planes and its regrouping keys, and
K11's cooperative shell walk, on the CPU: the plain version's window on
the streamed scenes of tests/test_torch_stream.py resumes a render
exactly and gives the same planes and keys whatever order it serves its
rays in; the keys against the drivers' former Morton and octant sorts; a
model of the cooperative shell walk against the per-thread one.

Tolerances: exact throughout (the plain window's planes against the
unbroken render and against another order, the keys against the former
sorts, each ray's visit sequence against the per-thread walk's).
"""

import numpy as np
import pytest
import torch

from cudaraytracer_tpu_torch.models import check_scenes as cs
from cudaraytracer_tpu_torch.ops import megakernel as tmk
from _torch_threads import one_intra_op_thread  # noqa: F401
from test_torch_stream import (DEPTH, N_RAYS, _cfg, _stream, _streamed,
                               _trays)


@pytest.mark.parametrize("draws", ["injected", "counter"])
def test_windowed_plain_dump_resumes_exactly(draws):
    """The plain version's window over the planes: [0, 2) writes the 13
    planes [rad | o | d | thr | alive] of every ray in its column; resuming
    [2, D + 1) in place, the rays served in reverse order, adds up to the
    unbroken render bit for bit, and leaves the dead rays' columns as they
    were."""
    _, ts, o, d, orders = _streamed("sphere_field")
    tables = tmk.build_mega_tables(ts, *orders)
    rays = _trays(o, d)
    stream = tmk.stream_tensor(_stream()[2], N_RAYS, DEPTH + 1) \
        if draws == "injected" else None
    cfg = _cfg("reference")
    want = tmk.trace_path_mega_plain(tables, rays, cfg, stream, 5)
    planes = torch.full((tmk.N_PLANES, N_RAYS), float("nan"))
    a = tmk.trace_path_mega_plain(tables, rays, cfg, stream, 5,
                                  window=tmk.Window(0, 2, planes))
    assert a is planes and not planes.isnan().any()
    assert set(a[12].tolist()) <= {0.0, 1.0} and a[12].any()
    was_dead = a[12] == 0.0
    dead = a[:, was_dead].clone()
    assert dead.shape[1] > 0
    rev = torch.arange(N_RAYS - 1, -1, -1, dtype=torch.int32)
    tmk.trace_path_mega_plain(tables, rays, cfg, stream, 5,
                              window=tmk.Window(2, None, planes, rev))
    np.testing.assert_array_equal(planes[:3].t().numpy(), want.numpy())
    np.testing.assert_array_equal(planes[:, was_dead].numpy(), dead.numpy())


def _box_dist2(seg: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """The kernel's box_dist2 of origins float32[R, 3] to boxes float32[S,
    8] -> float32[R, S]."""
    q = torch.minimum(torch.maximum(o[:, None], seg[None, :, 0:3]),
                      seg[None, :, 3:6]) - o[:, None]
    return q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1] + q[..., 2] * q[..., 2]


def _shells(seg: torch.Tensor, o: torch.Tensor, b: int) -> np.ndarray:
    """Each ray's shell of each box, as tri_shells ranks them ->
    int[R, S]."""
    d2 = _box_dist2(seg, o)
    dmin, dmax = d2.amin(1, keepdim=True), d2.amax(1, keepdim=True)
    scale = b / torch.clamp(dmax - dmin, min=1e-30)
    q = torch.floor((d2 - dmin) * scale)
    return torch.where(q >= 0, torch.clamp(q, max=b - 1), 0).long().numpy()


def _warp_walk(shells: np.ndarray, alive: np.ndarray, b: int) -> list:
    """A model of tri_shells_coop for one warp of 32 rays: per group of 32
    shells the union of the lanes' one-hot shell bits per box (lane t keeps
    box 32 w + t's), one ballot per shell into bits[s][w], then the walk of
    the set bits in (shell, table) order with __ffs, each lane entering box
    j in its own shell's pass -> each lane's visit sequence.  Asserts that
    every pair walked has a lane that enters it."""
    n_top = shells.shape[1]
    nw = -(-n_top // 32)
    visits = [[] for _ in range(32)]
    for g in range(0, b, 32):
        gb = min(b - g, 32)
        bits = np.zeros((gb, nw), np.int64)
        for w in range(nw):
            mine = np.zeros(32, np.int64)
            for t in range(min(n_top - 32 * w, 32)):
                s = np.where(alive, shells[:, 32 * w + t] - g, -1)
                onehot = np.where((s >= 0) & (s < 32), 1 << np.clip(s, 0, 31),
                                  0)
                mine[t] = np.bitwise_or.reduce(onehot)
            for sh in range(gb):
                bits[sh, w] = int(((mine >> sh) & 1) @ (1 << np.arange(32)))
        for sh in range(gb):
            for w in range(nw):
                m = int(bits[sh, w])
                while m:
                    j = 32 * w + (m & -m).bit_length() - 1
                    m &= m - 1
                    enter = alive & (shells[:, j] == g + sh)
                    assert enter.any(), "a vote on a pair no lane holds"
                    for lane in np.nonzero(enter)[0]:
                        visits[lane].append(j)
    return visits


def _walk_cases():
    """(top-level boxes, origins, alive) of the terrain's and a 20,480-
    triangle field's rays after one bounce (the plain version's window
    [0, 1)), and of 70 random boxes (three words of segments) seen from 512
    random origins."""
    _, ts, o, d, orders = _streamed("terrain")
    sf, cam = cs.field_scene(2, 2, 2.0, device="cpu")
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    fr = generate_pixel_rays(cam, 32, 16, 1, torch.arange(512),
                             generator=torch.Generator().manual_seed(2))
    out = []
    for tables, rays in ((tmk.build_mega_tables(ts, *orders), _trays(o, d)),
                         (tmk.morton_tables(sf), fr)):
        planes = torch.empty(tmk.N_PLANES, rays.origin.shape[0])
        tmk.trace_path_mega_plain(tables, rays, _cfg(), None, 3,
                                  window=tmk.Window(0, 1, planes))
        out.append((tables.tri_seg, planes[3:6].t(), planes[12] > 0))
    rng = np.random.default_rng(4)
    lo = rng.uniform(-10, 10, (70, 3)).astype(np.float32)
    seg = torch.from_numpy(np.concatenate(
        [lo, lo + rng.uniform(0.1, 3, (70, 3)).astype(np.float32),
         np.zeros((70, 2), np.float32)], 1))
    org = torch.from_numpy(rng.uniform(-12, 12, (512, 3)).astype(np.float32))
    out.append((seg, org, torch.from_numpy(rng.uniform(size=512) < 0.8)))
    return out


@pytest.mark.parametrize("shells", [1, 3, 8, 40])
def test_cooperative_shell_walk_keeps_each_rays_order(shells):
    """K11 under COOP, modelled warp by warp (32 rays, the union masks, the
    groups of 32 shells, dead lanes): every ray visits exactly the boxes of
    the per-thread tri_shells, in its order, and every (shell, box) pair
    the warp walks has a ray that enters it.  On the terrain's 6 segments,
    the field's 10 and 70 random boxes."""
    for seg, o, alive in _walk_cases():
        sh = _shells(seg, o, shells)
        assert len(np.unique(sh)) > min(shells, 2) - 1
        alive = alive.numpy()
        for w0 in range(0, o.shape[0], 32):
            lanes = slice(w0, w0 + 32)
            got = _warp_walk(sh[lanes], alive[lanes], shells)
            for lane, seq in enumerate(got):
                want = (sorted(range(seg.shape[0]),
                               key=lambda j: (sh[w0 + lane, j], j))
                        if alive[w0 + lane] else [])
                assert seq == want


def _morton_order_before(o, d, alive, octants):
    """The drivers' regrouping before the keys moved into the kernel: the
    30-bit Morton code of origins quantized over their own range, in int64
    (the octant key or the code), dead rays last, a stable argsort."""
    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    def q(a):
        lo = a.min()
        span = torch.clamp(a.max() - lo, min=1e-20)
        return torch.clamp((a - lo) / span * 1023.0, 0.0, 1023.0).to(
            torch.int64)

    code = (spread(q(o[:, 0])) << 2) | (spread(q(o[:, 1])) << 1) | spread(
        q(o[:, 2]))
    if octants:
        oct_ = (((d[:, 0] < 0).to(torch.int64) << 2)
                | ((d[:, 1] < 0).to(torch.int64) << 1)
                | (d[:, 2] < 0).to(torch.int64))
        code = (((code >> 18) << 18) | (oct_ << 15)
                | ((code >> 3) & ((1 << 15) - 1)))
    return torch.argsort(torch.where(alive, code, tmk.DEAD_KEY), stable=True)


def test_regroup_keys():
    """The plain key function (K10), on the sphere field's rays after two
    bounces: the octant bits are the direction's signs, dead rays take
    DEAD_KEY and sort last, alive-first keeps the ray order within each
    group, and over the origins' own range the Morton and octant keys sort
    as the drivers sorted before (today's Morton order)."""
    _, ts, o, d, orders = _streamed("sphere_field")
    tables = tmk.build_mega_tables(ts, *orders)
    planes = torch.empty(tmk.N_PLANES, N_RAYS)
    tmk.trace_path_mega_plain(tables, _trays(o, d), _cfg(), None, 6,
                              window=tmk.Window(0, 2, planes))
    o2, d2, alive = planes[3:6].t(), planes[6:9].t(), planes[12] > 0
    assert 0 < int(alive.sum()) < N_RAYS
    bounds = tables.key_bounds
    assert bounds.shape == (2, 3) and bool((bounds[1] > 0).all())
    for mode in (tmk.KEY_ALIVE, tmk.KEY_OCTANT, tmk.KEY_MORTON):
        key = tmk.regroup_keys(o2, d2, alive, mode, bounds)
        assert key.dtype == torch.int32
        assert bool((key[~alive] == tmk.DEAD_KEY).all())
        assert bool((key[alive] < tmk.DEAD_KEY).all())
        order = tmk._next_order(key)
        assert order.dtype == torch.int32
        assert bool(alive[order.long()][:int(alive.sum())].all())
    key = tmk.regroup_keys(o2, d2, alive, tmk.KEY_OCTANT, bounds)
    neg = (d2 < 0).to(torch.int32)
    assert torch.equal(((key >> 15) & 7)[alive],
                       ((neg[:, 0] << 2) | (neg[:, 1] << 1) | neg[:, 2])[alive])
    key = tmk.regroup_keys(o2, d2, alive, tmk.KEY_ALIVE, bounds)
    assert torch.equal(tmk._next_order(key).long(), torch.cat(
        [torch.nonzero(alive)[:, 0], torch.nonzero(~alive)[:, 0]]))
    lo = o2.amin(0)
    own = torch.stack([lo, torch.clamp(o2.amax(0) - lo, min=1e-20)])
    for mode, octants in ((tmk.KEY_MORTON, False), (tmk.KEY_OCTANT, True)):
        key = tmk.regroup_keys(o2, d2, alive, mode, own)
        assert torch.equal(tmk._next_order(key).long(),
                           _morton_order_before(o2, d2, alive, octants))


def test_plain_window_is_independent_of_the_order():
    """The plain window over the planes under a shuffled order gives the
    planes and keys of the identity order, at step 0 and resumed (the
    draws and the injected stream's row follow the ray id)."""
    _, ts, o, d, orders = _streamed("terrain")
    tables = tmk.build_mega_tables(ts, *orders)
    rays = _trays(o, d)
    stream = tmk.stream_tensor(_stream()[2], N_RAYS, DEPTH + 1)
    shuffled = torch.randperm(
        N_RAYS, generator=torch.Generator().manual_seed(9)).to(torch.int32)
    got = []
    for order in (None, shuffled):
        planes = torch.empty(tmk.N_PLANES, N_RAYS)
        key = torch.empty(N_RAYS, dtype=torch.int32)
        tmk.trace_path_mega_plain(tables, rays, _cfg(), stream, 0,
                                  window=tmk.Window(0, 2, planes, order, key,
                                                    tmk.KEY_OCTANT))
        first = planes.clone(), key.clone()
        tmk.trace_path_mega_plain(tables, rays, _cfg(), stream, 0,
                                  window=tmk.Window(2, 2, planes, order, key,
                                                    tmk.KEY_OCTANT))
        got.append((first, (planes, key)))
    for (a, ka), (b, kb) in zip(*got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert torch.equal(ka, kb)
