"""Engine subsystems: async back-end pipeline, running-range window,
checkpoint/resume."""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

from roborts_slam.engine import ScanStore, SlamEngine
from roborts_slam.io.checkpoint import load_checkpoint, save_checkpoint
from roborts_slam.io.scenes import SCENES, load_scene_map
from roborts_slam.io.simulate import simulate_log
from roborts_slam.utils.evaluation import ate_rmse, match_by_time
from tests.test_e2e_small import _small_config


@pytest.fixture(scope="module")
def icra_log():
    sc = SCENES["icra"]
    gt = load_scene_map(sc)
    return simulate_log(gt, sc.laser, odom_error=sc.odom_error,
                        range_noise=0.005, seed=3)


def test_device_store_mirrors_host():
    """The device-resident scan buffers must track the host store exactly
    through appends, pose corrections, and capacity growth — a stale pose
    here silently poisons every back-end chain map (caught as a
    checkpoint-resume trajectory divergence before this pin existed)."""
    rng = np.random.default_rng(0)
    st = ScanStore(max_points=8)
    st._DEV_BUCKET_START = 4          # exercise capacity doubling cheaply

    def check():
        pts, msk, nv, poses, cap = st.device_arrays()
        n = len(st)
        assert cap >= n
        np.testing.assert_array_equal(np.asarray(pts[:n]),
                                      np.stack(st._points))
        np.testing.assert_array_equal(np.asarray(msk[:n]),
                                      np.stack(st._masks))
        np.testing.assert_array_equal(np.asarray(nv[:n]), st._n_valid)
        np.testing.assert_allclose(np.asarray(poses[:n]),
                                   st.poses_array().astype(np.float32),
                                   atol=0)
        assert (np.asarray(nv[n:]) == 0).all()

    def add(i):
        st.add(rng.random((8, 2), np.float32).astype(np.float32),
               np.ones(8, bool), 8, np.array([float(i), -1.0, 0.1 * i]),
               np.zeros(3), i)

    for i in range(3):
        add(i)
    check()                            # initial build
    add(3)
    check()                            # in-place append
    st.set_pose(1, np.array([9.0, 9.0, 9.0]))
    check()                            # stale poses refreshed
    for i in range(4, 11):
        add(i)                         # overflows cap 4 -> rebuild at 16
    check()


def test_store_append_donation_policy():
    """Sync engines donate device-store appends (no O(capacity) copy per
    scan); async engines must NOT — a worker thread can hold the current
    buffer handles between its device_arrays() snapshot and its
    chain-match dispatch, and a donating append would delete them under
    it (use-after-donate)."""
    rng = np.random.default_rng(1)

    def add(st, i):
        st.add(rng.random((8, 2)).astype(np.float32), np.ones(8, bool), 8,
               np.array([float(i), 0.0, 0.0]), np.zeros(3), float(i))

    # async policy: old handles stay readable across an append
    st = ScanStore(max_points=8)
    st.donate_appends = False
    add(st, 0)
    pts, msk, nv, poses, _ = st.device_arrays()
    add(st, 1)
    st.device_arrays()                 # incremental append happens here
    assert not pts.is_deleted() and not poses.is_deleted()
    assert np.isfinite(float(jnp.sum(pts)))   # a reader can still use them

    # sync policy (default): the append consumes the old buffers
    st2 = ScanStore(max_points=8)
    assert st2.donate_appends
    add(st2, 0)
    pts2, *_ = st2.device_arrays()
    add(st2, 1)
    st2.device_arrays()
    assert pts2.is_deleted()


def test_running_range_window():
    store = ScanStore(max_points=8, running_range_max_scans=5,
                      running_range_max_distance=2.0)
    pts = np.zeros((8, 2), np.float32)
    msk = np.ones(8, bool)
    # walk along x in 0.5 m steps: span cap (2.0 m) binds before count cap
    for i in range(10):
        store.add(pts, msk, 8, np.array([0.5 * i, 0.0, 0.0]), np.zeros(3), i)
    ids = store.running_ids
    assert len(ids) <= 5
    ps = np.array([store.poses[j][:2] for j in ids])
    assert (ps.max(0) - ps.min(0)).max() <= 2.0 + 1e-9
    assert ids[-1] == 9       # newest always kept


def test_async_backend_pipeline(icra_log):
    cfg = _small_config()
    log = icra_log
    sync = SlamEngine(cfg, log.laser, synchronous_backend=True)
    t_sync = sync.run_log(log)
    async_e = SlamEngine(cfg, log.laser, synchronous_backend=False)
    t_async = async_e.run_log(log)      # run_log flushes via finish()
    assert async_e._backend_thread is None   # joined

    est_s, gt_s = match_by_time(t_sync, log.gt_poses, log.times)
    est_a, gt_a = match_by_time(t_async, log.gt_poses, log.times)
    ate_s = ate_rmse(est_s, gt_s)
    ate_a = ate_rmse(est_a, gt_a)
    # same graph construction stream => same links; timing may shift
    # correction application, so require quality parity not bit equality
    assert async_e.backend.num_links >= 1
    assert ate_a < max(2.0 * ate_s, 0.15), (ate_a, ate_s)


def test_warm_backend_is_side_effect_free(icra_log):
    """warm_backend pre-compiles the solver/correction/chain-match programs
    (so the first loop closure doesn't pay mid-run jit compiles) and must
    not perturb ANY engine state: continuing the run after warming must
    reproduce the unwarmed trajectory bit-for-bit."""
    cfg = _small_config()
    log = icra_log
    n_pre = 12

    plain = SlamEngine(cfg, log.laser, synchronous_backend=True)
    warmed = SlamEngine(cfg, log.laser, synchronous_backend=True)
    for eng in (plain, warmed):
        for i in range(n_pre):
            eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    # warm-up must actually succeed, not silently best-effort-skip: a
    # stale warm_fused signature once raised TypeError on every fused
    # bucket, leaving mid-run compiles AND the fused memory cap
    # unrecorded (the fused batch sizer depends on it)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        warmed.warm_backend(solver_buckets=(64,), match_buckets=(1,))
    skipped = [str(w.message) for w in caught
               if "skipping" in str(w.message)]
    assert not skipped, skipped
    if warmed._fused_backend and not cfg.use_running_range_scan_match:
        assert warmed.backend._measured_mem_fused, \
            "fused program's compiler-measured peak was not recorded"
    g = warmed.backend.graph
    n_v, n_e = g.num_vertices, len(g.edges)
    for eng in (plain, warmed):
        for i in range(n_pre, min(len(log), 60)):
            eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
        eng.finish()
    assert (warmed.backend.graph.num_vertices, warmed.backend.num_links) == \
        (plain.backend.graph.num_vertices, plain.backend.num_links)
    assert g.num_vertices >= n_v and len(g.edges) >= n_e
    np.testing.assert_array_equal(plain.trajectory_array(),
                                  warmed.trajectory_array())
    np.testing.assert_array_equal(plain.get_pub_map(), warmed.get_pub_map())


def test_checkpoint_roundtrip(tmp_path, icra_log):
    cfg = _small_config()
    log = icra_log
    half = len(log) // 2

    full = SlamEngine(cfg, log.laser)
    for i in range(len(log)):
        full.process(log.ranges[i], log.odom[i], float(log.times[i]))

    part = SlamEngine(cfg, log.laser)
    for i in range(half):
        part.process(log.ranges[i], log.odom[i], float(log.times[i]))
    path = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(part, path)

    resumed = load_checkpoint(path)
    assert len(resumed.store) == len(part.store)
    assert resumed.backend.graph.num_vertices == part.backend.graph.num_vertices
    np.testing.assert_allclose(resumed.store.poses_array(),
                               part.store.poses_array(), atol=1e-12)
    for i in range(half, len(log)):
        resumed.process(log.ranges[i], log.odom[i], float(log.times[i]))

    t_full = full.trajectory_array()
    t_res = resumed.trajectory_array()
    assert t_full.shape == t_res.shape
    # resume is bit-exact in state, so trajectories agree to float tolerance
    np.testing.assert_allclose(t_res, t_full, atol=1e-5)


def test_engine_dedistortion_path(icra_log):
    """use_odom_correct + laser.scan_time wires LaserDataProcessor parity
    into ingest; the corrected run must still track ground truth."""
    import dataclasses
    cfg = _small_config().replace(use_odom_correct=True)
    log = icra_log
    laser = dataclasses.replace(log.laser, scan_time=0.025)
    eng = SlamEngine(cfg, laser)
    n = len(log) // 2
    for i in range(n):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    eng.finish()
    assert eng.diag.scans_processed > 20
    est, gt = match_by_time(eng.trajectory_array(), log.gt_poses, log.times)
    assert ate_rmse(est, gt) < 0.15


def test_async_backend_survives_finish(icra_log):
    """finish() must not be terminal: run_log flushes via finish(), and a
    second run on the same engine must still drive the back end."""
    cfg = _small_config()
    log = icra_log
    eng = SlamEngine(cfg, log.laser, synchronous_backend=False)
    third = len(log) // 3
    for i in range(third):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    eng.finish()
    links_before = eng.backend.num_links
    assert links_before > 0
    for i in range(third, 2 * third):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    eng.finish()
    assert eng.backend.num_links > links_before, (
        "backend thread did not restart after finish()")


def test_pub_map_grows_with_trajectory(icra_log):
    """The published map grows on demand when scans escape the preallocated
    extent (GridMapBase::UpdateBound/ExtendSize, grid_map_base.h:188-274):
    a run whose world_size is far too small must reproduce the map content
    of a comfortably-sized run instead of warn-then-clip."""
    log = icra_log
    cfg = _small_config().replace(match_map_window=10.0)
    n = min(90, len(log))

    big = SlamEngine(cfg, log.laser, world_size=40.0)
    small = SlamEngine(cfg, log.laser, world_size=8.0)
    for i in range(n):
        big.process(log.ranges[i], log.odom[i], float(log.times[i]))
        small.process(log.ranges[i], log.odom[i], float(log.times[i]))

    sspec = small.fspec.pub_spec
    assert max(sspec.width, sspec.height) > 256, (
        "pub map did not grow past its 8 m (256-cell) preallocation")
    tb, ts = big.trajectory_array(), small.trajectory_array()
    assert tb.shape == ts.shape
    np.testing.assert_allclose(ts[:, 1:3], tb[:, 1:3], atol=5e-3)

    # identical content over the aligned overlap; nothing outside it
    pb, ps = big.get_pub_map(), small.get_pub_map()
    ob = np.asarray(big.state.pub.offset, np.float64)
    osm = np.asarray(small.state.pub.offset, np.float64)
    res = cfg.map_resolution
    shift = np.round((osm - ob) / res).astype(int)          # (x, y) cells
    np.testing.assert_allclose((osm - ob) / res, shift, atol=1e-3)
    Hb, Wb = pb.shape
    Hs, Ws = ps.shape
    y0, x0 = max(0, -shift[1]), max(0, -shift[0])
    y1, x1 = min(Hb, Hs - shift[1]), min(Wb, Ws - shift[0])
    b = pb[y0:y1, x0:x1]
    s = ps[y0 + shift[1]:y1 + shift[1], x0 + shift[0]:x1 + shift[0]]
    assert (b == 100).sum() > 200, "comparison region carries no walls"
    mismatch = float(np.mean(b != s))
    assert mismatch < 0.005, f"map content diverged: {mismatch:.4%} cells"
    outside = pb.copy()
    outside[y0:y1, x0:x1] = -1
    assert (outside == -1).all(), "big run has content the grown map misses"


def test_async_corrections_reanchor_trailing_scans(icra_log):
    """Corrections computed from a stale snapshot (async mode) must carry
    the trailing scans with the last corrected scan's rigid delta, so
    relative placement across the snapshot boundary is preserved exactly
    (the reference corrects EVERY stored scan under the map mutex,
    slam_processor.cpp:329-370)."""
    cfg = _small_config()
    log = icra_log
    eng = SlamEngine(cfg, log.laser, synchronous_backend=True)
    i = 0
    while len(eng.store) < 8 and i < len(log):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
        i += 1
    n = len(eng.store)
    assert n >= 8
    n_corr = n - 3                      # 3 scans trail the solve snapshot
    before = eng.store.poses_array().copy()

    dth = 0.12
    c, s = np.cos(dth), np.sin(dth)
    tr = np.array([0.35, -0.2])

    def apply_delta(p):
        return np.array([tr[0] + c * p[0] - s * p[1],
                         tr[1] + s * p[0] + c * p[1], p[2] + dth])

    corrected = np.stack([apply_delta(before[k]) for k in range(n_corr)])
    eng._apply_corrections(corrected)

    after = eng.store.poses_array()
    for k in range(n):                  # trailing scans included: tight pin
        exp = apply_delta(before[k])
        np.testing.assert_allclose(after[k, :2], exp[:2], atol=1e-9)
        dang = after[k, 2] - exp[2]
        assert abs(np.arctan2(np.sin(dang), np.cos(dang))) < 1e-9
    # trajectory mirrors the store, boundary included
    traj = eng.trajectory_array()
    np.testing.assert_allclose(traj[-1, 1:3], after[-1, :2], atol=1e-9)


def test_windowed_running_range_match(icra_log):
    """use_running_range_scan_match: the engine matches against maps rebuilt
    from the running-range window (the reference's disabled windowed path,
    slam_processor.cpp:134-159, enabled here via config)."""
    log = icra_log
    cfg = _small_config().replace(use_running_range_scan_match=True,
                                  running_range_size=12)
    engine = SlamEngine(cfg, log.laser, synchronous_backend=True)
    n = min(120, len(log))
    for i in range(n):
        engine.process(log.ranges[i], log.odom[i], float(log.times[i]))
    assert engine.fspec.window_fine_spec is not None
    assert engine.diag.scans_processed > 10, engine.diag
    traj = engine.trajectory_array()
    est, gt = match_by_time(traj, log.gt_poses, log.times)
    ate = ate_rmse(est, gt)
    odom_est = log.odom[np.searchsorted(log.times, traj[:, 0]).clip(0, len(log) - 1)]
    ate_odom = ate_rmse(odom_est, gt)
    print(f"windowed ATE={ate:.3f} odom={ate_odom:.3f}")
    assert ate < 0.15 and np.isfinite(ate)


def test_pub_growth_pad_and_post_match_safety(icra_log):
    """Pub-map growth hardening (grid_map_base.h:257-274 grows post-match,
    so the reference never clips): (a) the pre-dispatch pad must cover a
    matched pose displaced from the prediction by the full stacked
    correlative translation search bound; (b) a correction beyond the pad
    (large rotation) must trigger the post-match clip rebuild and leave
    every endpoint inside the grown extent with its stamp present."""
    cfg = _small_config()
    log = icra_log
    eng = SlamEngine(cfg, log.laser, synchronous_backend=True)
    i = 0
    while len(eng.store) < 2 and i < len(log):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
        i += 1
    assert len(eng.store) >= 2
    sid = len(eng.store) - 1
    pts = eng.store._points[sid]
    msk = eng.store._masks[sid]
    pose = eng.store.poses[sid].copy()

    # (a) park the scan near the map edge, grow with the derived pad, then
    # displace by (pad - cell): the grown extent must already cover it
    spec = eng.fspec.pub_spec
    extent0 = np.array([spec.width, spec.height]) * spec.resolution
    edge_pose = pose + np.array([0.6 * extent0[0], 0.0, 0.0])
    eng._maybe_grow_pub(edge_pose, pts, msk)
    pad = eng._search_pad()
    at_pad = edge_pose + np.array([pad - spec.resolution, 0.0, 0.0])
    bmin, bmax = eng._scan_world_bbox(at_pad, pts, msk)
    spec = eng.fspec.pub_spec                   # may have been replaced
    off = np.asarray(eng.state.pub.offset, np.float64)
    extent = np.array([spec.width, spec.height]) * spec.resolution
    assert (bmin + off >= 0).all() and (bmax + off <= extent).all(), \
        "pad must absorb the full translation search bound"
    before = eng.diag.pub_clip_rebuilds
    eng._ensure_pub_covers(at_pad, pts, msk)
    assert eng.diag.pub_clip_rebuilds == before   # no rebuild needed

    # (b) beyond the pad AND the 256-cell growth granule: translate past
    # the current (grown) extent and flip the heading
    far_pose = edge_pose + np.array([extent[0], 0.0, np.pi])
    eng.store.set_pose(sid, far_pose)
    eng._ensure_pub_covers(far_pose, pts, msk)
    assert eng.diag.pub_clip_rebuilds == before + 1
    bmin, bmax = eng._scan_world_bbox(far_pose, pts, msk)
    spec = eng.fspec.pub_spec
    off = np.asarray(eng.state.pub.offset, np.float64)
    extent = np.array([spec.width, spec.height]) * spec.resolution
    assert (bmin + off >= 0).all() and (bmax + off <= extent).all()
    # the rebuilt map carries the scan's stamps at the moved pose: endpoint
    # cells must show hits (clipped stamps would leave them at zero)
    hits = np.asarray(eng.state.pub.hits)
    pv = pts[msk]
    c, s = np.cos(far_pose[2]), np.sin(far_pose[2])
    wx = far_pose[0] + c * pv[:, 0] - s * pv[:, 1]
    wy = far_pose[1] + s * pv[:, 0] + c * pv[:, 1]
    gx = np.floor((wx + off[0]) / spec.resolution).astype(int)
    gy = np.floor((wy + off[1]) / spec.resolution).astype(int)
    frac = (hits[gy, gx] > 0).mean()
    assert frac > 0.5, f"only {frac:.0%} of moved endpoints stamped"


def test_correction_growth_covers_moved_scans(icra_log):
    """A pose-graph correction that swings the trajectory outside the pub
    extent must grow the map before the rebuild (the round-3 path stamped
    clipped, silently losing those cells)."""
    cfg = _small_config()
    log = icra_log
    eng = SlamEngine(cfg, log.laser, synchronous_backend=True)
    i = 0
    while len(eng.store) < 3 and i < len(log):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
        i += 1
    assert len(eng.store) >= 3
    # raw hit mass is NOT preserved across rebuilds even at identity — the
    # reference's own quirk (live first scan stamps with occu factor
    # 2*min_passthrough, slam_processor.cpp:540-552, while the rebuild
    # re-adds scan 0 min_passthrough times at default factors, :350-353) —
    # so pin the PUBLISHED map product: an in-extent identity rebuild and
    # the far-shifted rebuild must publish the same occupied-cell count
    # (a clipped stamp would lose occupied cells).
    eng._apply_corrections(eng.store.poses_array())      # identity rebuild
    occ_before = int((eng.get_pub_map() == 100).sum())
    passes_before = float(np.asarray(eng.state.pub.passes).sum())
    assert occ_before > 0
    shift = np.array([25.0, -18.0, 0.0])        # far outside the 20 m world
    eng._apply_corrections(eng.store.poses_array() + shift)
    bmin, bmax = eng.store.scans_world_bbox()
    spec = eng.fspec.pub_spec
    off = np.asarray(eng.state.pub.offset, np.float64)
    extent = np.array([spec.width, spec.height]) * spec.resolution
    assert (bmin + off >= -1e-6).all() and (bmax + off <= extent + 1e-6).all()
    occ_after = int((eng.get_pub_map() == 100).sum())
    passes_after = float(np.asarray(eng.state.pub.passes).sum())
    # the shift is an exact cell multiple (25/-18 m at 0.05 m), so the
    # rebuilt pattern is the same lattice pattern translated: both the
    # carve mass and the published occupied set are preserved
    assert passes_after == passes_before, (passes_after, passes_before)
    assert occ_after == occ_before, (occ_after, occ_before)


def test_async_stress_slow_corrections(icra_log):
    """Hammer the async pipeline: force a solve +
    correction on EVERY drained back-end batch and hold each correction
    ~50 ms before applying, so the front end streams scans into the store
    while corrections from stale snapshots land (the reference serializes
    this under map_mutex_, slam_processor.cpp:329-426; here the re-anchor
    path must absorb it). After finish() every cross-thread structure must
    be mutually consistent."""
    import time as _t

    cfg = _small_config()
    log = icra_log
    eng = SlamEngine(cfg, log.laser, synchronous_backend=False)

    orig_try = eng.backend.try_close_loop
    def eager_try(scan_id, **kwargs):
        out = orig_try(scan_id, **kwargs)
        eng.backend.force_optimize()      # correction on every batch
        return out
    eng.backend.try_close_loop = eager_try

    orig_apply = eng._apply_corrections
    n_applied = [0]
    def slow_apply(corrected):
        _t.sleep(0.05)                    # let the frontend race ahead
        n_applied[0] += 1
        orig_apply(corrected)
    eng.backend.on_corrections = slow_apply

    for i in range(min(len(log), 250)):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    eng.finish()

    # each drained worker batch ends in one forced correction; on a slow
    # host the worker drains few, large batches — >= 2 proves at least one
    # correction landed from a snapshot the stream had already outrun
    assert n_applied[0] >= 2, "stress premise: corrections raced the stream"
    n = len(eng.store)
    # trajectory mirrors the store exactly (corrections rewrite both)
    assert len(eng.trajectory) == n == eng.backend.graph.num_vertices
    traj = eng.trajectory_array()
    np.testing.assert_allclose(traj[:, 1:], eng.store.poses_array(),
                               atol=0, rtol=0)
    # device-resident mirror tracks the host store through the races
    pts, msk, nv, poses, cap = eng.store.device_arrays()
    np.testing.assert_array_equal(np.asarray(pts[:n]),
                                  np.stack(eng.store._points))
    np.testing.assert_allclose(np.asarray(poses[:n]),
                               eng.store.poses_array().astype(np.float32),
                               atol=0)
    # barycenter cache equals a from-scratch recompute
    np.testing.assert_allclose(eng.store.barycenters(),
                               eng.store._bary_of(range(n)), atol=1e-12)
    # the pub snapshot is a LIVE COPY in async mode (the frontend's next
    # dispatch donates the state arrays, so handing out the live objects
    # was a use-after-donate race): alive, spec-paired, content-equal
    pub_spec, hits, passes, off = eng.store.pub_map_arrays()
    assert not hits.is_deleted() and not passes.is_deleted()
    assert hits is not eng.state.pub.hits    # copied, not aliased
    np.testing.assert_array_equal(np.asarray(hits),
                                  np.asarray(eng.state.pub.hits))
    np.testing.assert_array_equal(np.asarray(passes),
                                  np.asarray(eng.state.pub.passes))
    assert pub_spec == eng.fspec.pub_spec
    # engine stays usable after finish(): the worker revives
    j0 = len(log) - 5
    for i in range(j0, len(log)):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    eng.finish()
    assert np.isfinite(eng.trajectory_array()).all()


def test_fused_backend_matches_unfused(icra_log):
    """The fused dispatch (frontend step + LinkNearChains/TryCloseLoop
    coarse chain matches + donated store append in ONE program,
    backend/processor.fused_frontend_chain_step) must reproduce the
    separate-dispatch path: same kept set, same graph, same trajectory —
    and the device store mirror must survive donated appends across
    capacity growth."""
    cfg = _small_config()
    log = icra_log
    n_feed = min(len(log), 160)
    runs = {}
    for fused in (False, True):
        eng = SlamEngine(cfg, log.laser, synchronous_backend=True,
                         fused_backend=fused)
        eng.store._DEV_BUCKET_START = 16   # force growth under donation
        for i in range(n_feed):
            eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
        eng.finish()
        runs[fused] = eng
    e0, e1 = runs[False], runs[True]
    assert e1.diag.fused_steps > 0 and e1.backend.num_fused_hits > 0
    assert e1.backend.num_chain_dispatches < e0.backend.num_chain_dispatches
    assert len(e0.store) == len(e1.store)
    assert (e0.backend.num_links, e0.backend.num_loop_closures) == \
        (e1.backend.num_links, e1.backend.num_loop_closures)
    np.testing.assert_allclose(e1.trajectory_array(), e0.trajectory_array(),
                               atol=1e-5)
    n = len(e1.store)
    pts, msk, nv, poses, _cap = e1.store.device_arrays()
    np.testing.assert_array_equal(np.asarray(pts[:n]),
                                  np.stack(e1.store._points))
    np.testing.assert_array_equal(np.asarray(nv[:n]), e1.store._n_valid)
    np.testing.assert_allclose(np.asarray(poses[:n]),
                               e1.store.poses_array().astype(np.float32),
                               atol=0)


def test_pose_stream_interpolates_across_correction(icra_log):
    """pose_at(t) — the fixed-rate pose channel replacing the reference's
    100 Hz map→odom TF thread (roborts_slam_node.cpp:178-196) — must (a)
    interpolate odometry between kept scans through the latest map→odom
    transform, and (b) jump WITH a pose-graph correction: after poses move,
    pose_at at the last scan's stamp must track the corrected pose, not
    the pre-correction one."""
    cfg = _small_config()
    log = icra_log
    eng = SlamEngine(cfg, log.laser, synchronous_backend=True)
    n_feed = min(len(log), 60)
    for i in range(n_feed):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    eng.finish()
    assert len(eng.trajectory) >= 3

    # (a) at a kept scan's own stamp, pose_at == that scan's pose
    t_k, p_k = eng.trajectory[-1]
    np.testing.assert_allclose(eng.pose_at(t_k), p_k, atol=1e-6)
    # between the last two odom samples the stream moves smoothly: the
    # interpolated pose lies between the endpoint poses componentwise
    (t0, _), (t1, _) = eng._odom_history[-2], eng._odom_history[-1]
    tm = 0.5 * (t0 + t1)
    pm = eng.pose_at(tm)
    pa, pb = eng.pose_at(t0), eng.pose_at(t1)
    lo = np.minimum(pa[:2], pb[:2]) - 1e-9
    hi = np.maximum(pa[:2], pb[:2]) + 1e-9
    assert ((pm[:2] >= lo) & (pm[:2] <= hi)).all(), (pa, pm, pb)

    # (b) a correction boundary: shift every stored pose rigidly and apply
    shift = np.array([0.35, -0.2, 0.1])
    corrected = np.stack([
        np.asarray(p, np.float64) + shift for p in eng.store.poses])
    eng._apply_corrections(corrected)
    p_after = eng.pose_at(t_k)
    np.testing.assert_allclose(p_after[:2], (p_k + shift)[:2], atol=1e-5)
    # the channel stays continuous AFTER the jump: interpolation still
    # follows odometry under the refreshed transform
    p_mid_after = eng.pose_at(tm)
    assert np.isfinite(p_mid_after).all()


def test_map_snapshot_hook(icra_log):
    """The every-N-scans live map snapshot hook (the 1 Hz PublishMapThread
    analog, roborts_slam_node.cpp:355-488) fires with a rendered grid."""
    cfg = _small_config()
    log = icra_log
    eng = SlamEngine(cfg, log.laser, synchronous_backend=True)
    snaps = []
    eng.map_snapshot_every = 5
    eng.on_map_snapshot = lambda n, grid: snaps.append((n, grid))
    poses = []
    eng.on_pose = lambda t, p: poses.append((t, p))
    for i in range(min(len(log), 40)):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    eng.finish()
    kept = len(eng.store)
    assert len(snaps) == kept // 5
    n0, grid = snaps[0]
    assert set(np.unique(grid)) <= {-1, 0, 100}
    assert len(poses) == kept


def test_async_fused_carries_prematched(icra_log):
    """Round-5: async mode must ride the fused dispatch too — the worker
    consumes the prematched chain rows from the queue instead of redoing
    the chain match (async once did 1.19-1.33 dispatches per scan vs
    sync's 1.0 because prematched was dropped)."""
    cfg = _small_config()
    log = icra_log
    n_feed = min(len(log), 160)
    eng = SlamEngine(cfg, log.laser, synchronous_backend=False,
                     fused_backend=True)
    import time as _t

    for i in range(n_feed):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
        # let the worker drain so the frontend's chain pre-discovery sees
        # a current graph — under suite load the worker can lag several
        # scans, which only lowers the fused hit rate in production but
        # makes this test's premise (fused steps happen) nondeterministic
        for _ in range(200):
            if eng._backend_queue.empty():
                break
            _t.sleep(0.005)
    eng.finish()
    assert eng.diag.fused_steps > 0
    assert eng.backend.num_fused_hits > 0
    # the worker must have consumed most fused results: separate chain
    # dispatches only on misses/corrections
    assert (eng.backend.num_chain_dispatches
            <= eng.backend.num_fused_misses + eng.backend.num_solves + 4), (
        eng.backend.num_chain_dispatches, eng.backend.num_fused_misses)
    # quality: same scene must still close loops / build links
    assert eng.backend.num_links >= 1
    assert np.isfinite(eng.trajectory_array()).all()


def test_pipelined_fetch_matches_blocking(icra_log):
    """The double-buffered fetch pipeline (round 5: dispatch k+1..k+D
    while scan k's summary fetch is in flight) must reproduce the
    blocking path: same kept scans, same trajectory, same graph — the
    device-resident odometry/cursor make every dispatch independent of
    the pending fetches, so only host bookkeeping lags."""
    cfg = _small_config()
    log = icra_log
    n_feed = min(len(log), 160)
    runs = {}
    for pipelined in (False, True):
        eng = SlamEngine(cfg, log.laser, synchronous_backend=True,
                         fused_backend=True)
        eng.pipelined_fetch = pipelined
        eng.pipeline_depth = 3
        for i in range(n_feed):
            eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
        eng.finish()
        assert not eng._inflight
        runs[pipelined] = eng
    e0, e1 = runs[False], runs[True]
    assert len(e0.store) == len(e1.store), (len(e0.store), len(e1.store))
    assert (e0.backend.num_links, e0.backend.num_loop_closures) == \
        (e1.backend.num_links, e1.backend.num_loop_closures)
    np.testing.assert_allclose(e1.trajectory_array(), e0.trajectory_array(),
                               atol=1e-4)
    # the device store mirror must agree with the host lists after the
    # cursor-driven appends
    n = len(e1.store)
    pts, msk, nv, poses, _cap = e1.store.device_arrays()
    np.testing.assert_array_equal(np.asarray(pts[:n]),
                                  np.stack(e1.store._points))
    np.testing.assert_allclose(np.asarray(poses[:n]),
                               e1.store.poses_array().astype(np.float32),
                               atol=1e-6)
    # pub maps identical
    np.testing.assert_array_equal(e0.get_pub_map(), e1.get_pub_map())


def test_pub_snapshot_survives_rejected_scan(icra_log):
    """The back-end's pub-map snapshot (pub_map_arrays) must stay usable
    after a REJECTED scan: the rejecting dispatch still donates the
    previous state, so the snapshot must be refreshed unconditionally —
    pre-fix it was only refreshed on accepted scans and a later
    force_graph_optimize / worker read hit deleted buffers."""
    cfg = _small_config()
    log = icra_log
    eng = SlamEngine(cfg, log.laser, synchronous_backend=True)
    rng = np.random.default_rng(7)
    for i in range(10):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    # garbage sweep at a displaced odometry: passes the move gate, fails
    # the score gate
    bad = rng.uniform(0.3, 0.9 * log.laser.range_max,
                      log.ranges[10].shape).astype(np.float32)
    odom = np.asarray(log.odom[10], np.float64) + np.array([0.5, 0.4, 0.3])
    kept = eng.process(bad, odom, float(log.times[10]) + 0.05)
    assert not kept, "garbage scan unexpectedly accepted"
    spec, hits, passes, off = eng.store.pub_map_arrays()
    assert not hits.is_deleted() and not passes.is_deleted()
    eng.force_graph_optimize()        # reads the snapshot; must not raise
    eng.finish()


def test_pipelined_pose_mirror_refreshes_after_correction(icra_log):
    """A pose-graph correction marks the device pose mirror stale
    (ScanStore.set_pose); the NEXT pipelined dispatch must rebuild it
    before any chain gather reads it. A round-5 bug had install_buffers
    clearing the stale flag while the pre-correction buffer stayed
    installed, so every post-closure chain match stamped maps from
    pre-correction poses."""
    cfg = _small_config()
    log = icra_log
    eng = SlamEngine(cfg, log.laser, synchronous_backend=True,
                     fused_backend=True)
    eng.pipelined_fetch = True
    eng.pipeline_depth = 2
    for i in range(min(len(log), 50)):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    eng._drain_pipeline()
    n = len(eng.store)
    assert n >= 5
    # rigid-shift correction through the same path a loop closure uses
    shift = np.array([0.3, -0.15, 0.05])
    corrected = np.stack([
        np.asarray(p, np.float64) + shift for p in eng.store.poses])
    eng._apply_corrections(corrected)
    assert eng.store._dev_poses_stale
    # next pipelined scans must dispatch against the CORRECTED mirror
    for i in range(50, min(len(log), 54)):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    dev = np.asarray(eng.store._dev_poses[:n])
    np.testing.assert_allclose(dev, eng.store.poses_array()[:n].astype(
        np.float32), atol=1e-5)


def test_pipelined_snapshot_drain_keeps_commit_order(icra_log):
    """Events that drain the pipeline mid-reconcile (map snapshots here)
    must not let a younger in-flight scan commit before the current one:
    store ids, the device append order, and graph vertex ids all key off
    commit order. (Pre-fix, the snapshot drain ran between store.add and
    update_graph and a nested reconcile tripped the vertex-id assert /
    swapped device store slots.)"""
    cfg = _small_config()
    log = icra_log
    eng = SlamEngine(cfg, log.laser, synchronous_backend=True,
                     fused_backend=True)
    eng.pipelined_fetch = True
    eng.pipeline_depth = 3
    snaps = []
    eng.map_snapshot_every = 2   # force frequent mid-reconcile drains
    eng.on_map_snapshot = lambda n, grid: snaps.append(n)
    for i in range(min(len(log), 80)):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    eng.finish()
    assert snaps, "snapshot hook never fired"
    n = len(eng.store)
    assert eng.backend.graph.num_vertices == n
    # host/device store slots must agree scan-for-scan
    pts, msk, nv, poses, _cap = eng.store.device_arrays()
    np.testing.assert_array_equal(np.asarray(pts[:n]),
                                  np.stack(eng.store._points))
    np.testing.assert_allclose(np.asarray(poses[:n]),
                               eng.store.poses_array().astype(np.float32),
                               atol=1e-6)


def test_pipelined_epoch_timestamps_keep_time_escape(icra_log):
    """UNIX-epoch stamps (t ~ 1.76e9, f32 ulp = 128 s) must not break the
    in-program MoveEnough clock: device times ship RELATIVE to the first
    scan's stamp. Pre-fix, consecutive stamps quantized to the same f32
    value, so a stationary robot's time-escape scans (kept every
    move_time_threshold seconds) were all dropped on device."""
    cfg = _small_config()
    log = icra_log
    n_pre = 20
    n_hold = 4
    dt = cfg.move_time_threshold + 0.5
    kept_hold = {}
    for off in (0.0, 1.7564e9):
        eng = SlamEngine(cfg, log.laser, synchronous_backend=True,
                         fused_backend=True)
        eng.pipelined_fetch = True
        eng.pipeline_depth = 2
        for i in range(n_pre):
            eng.process(log.ranges[i], log.odom[i],
                        float(log.times[i]) + off)
        eng._drain_pipeline()
        before = len(eng.store)
        # robot parks: same pose/scan, stamps spaced past the time escape
        t0 = float(log.times[n_pre - 1]) + off
        for k in range(1, n_hold + 1):
            eng.process(log.ranges[n_pre - 1], log.odom[n_pre - 1],
                        t0 + k * dt)
        eng.finish()
        kept_hold[off] = len(eng.store) - before
    assert kept_hold[0.0] >= 1            # the escape fires at small t
    assert kept_hold[1.7564e9] == kept_hold[0.0], kept_hold


def test_checkpoint_resume_under_pipeline(tmp_path, icra_log):
    """Round 5: a checkpoint taken mid-run (the save drains the fetch
    pipeline) must resume into pipelined mode with the device move-gate
    clock seeded — the resumed trajectory must match a straight-through
    pipelined run."""
    cfg = _small_config()
    log = icra_log
    n1, n2 = 60, 120

    ref = SlamEngine(cfg, log.laser, synchronous_backend=True)
    ref.pipelined_fetch = True
    for i in range(n2):
        ref.process(log.ranges[i], log.odom[i], float(log.times[i]))
    ref.finish()

    a = SlamEngine(cfg, log.laser, synchronous_backend=True)
    a.pipelined_fetch = True
    for i in range(n1):
        a.process(log.ranges[i], log.odom[i], float(log.times[i]))
    path = str(tmp_path / "pipe.ckpt.npz")
    save_checkpoint(a, path)          # drains in-flight scans first
    assert not a._inflight

    b = load_checkpoint(path)
    b.pipelined_fetch = True
    for i in range(n1, n2):
        b.process(log.ranges[i], log.odom[i], float(log.times[i]))
    b.finish()

    assert len(b.store) == len(ref.store), (len(b.store), len(ref.store))
    np.testing.assert_allclose(b.trajectory_array(), ref.trajectory_array(),
                               atol=1e-4)
