#!/usr/bin/env python3
"""Prove that the SLAM engine runs on one NVIDIA GPU, end to end.

Usage:
    python chip_smoke.py               # phases 0-4 on one GPU
    python chip_smoke.py --four-cards  # phase 5 only, on four GPUs

Phases, all in this one JAX process (``nvidia-smi`` runs in a child that
never imports JAX):

0. device: require a GPU; print its kind, count, name and power limit.
1. parity at real widths against the NumPy references in
   ``roborts_slam/bench/cpu_reference.py``: the three correlative tiers on a
   2048² fine map with a 1081-beam scan, the pub-map mark image and the
   consistency check's bad-ray count on a willow-sized pub map, the SPA
   solve on a 1024-node loop graph and the Gauss-Newton refine.
2. golden replay: tests/data/golden_{icra,willow}.npz through ``SlamEngine``:
   the same kept scans, links and loop closures as on the CPU that
   recorded them; and, stepped in lockstep from the CPU's own state, every
   front-end pose within the golden's 2e-3 (see ``phase_golden``).
3. end to end: a corridor loop through the generated willow scene with the
   reference simulation profile (1 cm fine map over the derived 50 m
   world), through the blocking ``SlamEngine``, until past a loop closure;
   ATE against ground truth.
4. timing of the plain XLA paths: each correlative tier, the mark image and
   the map-consistency penalty.
5. (``--four-cards`` only) the edge-sharded SPA solve and the sharded chain
   matcher on a 4-GPU mesh against their single-device results.

Any failed check exits non-zero before the last line. The last line of
standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SCORE_ATOL = 1e-4        # correlative scores vs the serial reference
SPA_REL_COST = 1e-4      # SPA cost vs float64 dense LM
GN_POS_TOL = 1e-4        # Gauss-Newton refine vs float64 (m)
CHAIN_COV_REL = 1e-2     # chain covariance entry vs sqrt(var_i var_j)
E2E_ATE_BOUND = 0.15     # m, the icra end-to-end test's bound


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def log(msg: str):
    print(msg, flush=True)


# ---- phase 0 ---------------------------------------------------------------

def phase_device() -> dict:
    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform} ({dev.device_kind})",
              file=sys.stderr)
        sys.exit(2)
    from roborts_slam.utils.compile_cache import enable_compile_cache
    from roborts_slam.utils.profiling import gpu_cards

    cache = enable_compile_cache()
    card = gpu_cards()
    log(f"[0] device_kind={dev.device_kind} count={len(devs)}")
    log(f"[0] nvidia-smi name,power.limit: {card}")
    log(f"[0] jax {jax.__version__}, compile cache {cache}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devs), "card": card.splitlines()[0]}


# ---- shared workloads ------------------------------------------------------

def willow_scene():
    from roborts_slam.io.scenes import SCENES, load_scene_map

    sc = SCENES["willow"]
    return sc, load_scene_map(sc)


def cell_centred_scan(rng, n: int, max_r: float, inv_res: float,
                      offset, pose):
    """Sensor-frame points whose map-frame endpoints sit within 0.3 cells of
    a cell centre, so float rounding cannot decide their cell."""
    off = np.asarray(offset, np.float64)
    ang = rng.uniform(-2.36, 2.36, n) + pose[2]
    r = rng.uniform(0.3, max_r, n)
    ex = (pose[0] + off[0] + r * np.cos(ang)) * inv_res
    ey = (pose[1] + off[1] + r * np.sin(ang)) * inv_res
    ex = np.round(ex) + rng.uniform(-0.3, 0.3, n)
    ey = np.round(ey) + rng.uniform(-0.3, 0.3, n)
    wx, wy = ex / inv_res - off[0] - pose[0], ey / inv_res - off[1] - pose[1]
    c, s = np.cos(pose[2]), np.sin(pose[2])
    return np.stack([c * wx + s * wy, -s * wx + c * wy], -1).astype(np.float32)


def pub_workload(cfg, laser_range: float, world: float, seed: int = 0):
    """Willow-sized pub map with occupied blobs, a sensor pose that is not
    axis-aligned and a full 1081-beam scan reaching ``laser_range``."""
    import jax.numpy as jnp

    from roborts_slam.models.grid_map import CountMap, pub_map_spec

    spec = pub_map_spec(cfg, laser_range, world)
    rng = np.random.default_rng(seed)
    passes = np.floor(rng.random((spec.height, spec.width)) * 9)
    hits = passes * (rng.random((spec.height, spec.width)) > 0.99)
    offset = np.array([0.5, 0.5]) * spec.width * spec.resolution
    cmap = CountMap(jnp.asarray(hits, jnp.float32),
                    jnp.asarray(passes, jnp.float32),
                    jnp.asarray(offset, jnp.float32))
    pose = np.array([1.37, -2.21, 0.61])
    P = cfg.max_points
    pts = np.zeros((P, 2), np.float32)
    pts[:1081] = cell_centred_scan(rng, 1081, laser_range * 0.95,
                                   spec.inv_res, offset, pose)
    mask = np.zeros(P, bool)
    mask[:1081] = True
    return spec, cmap, pose.astype(np.float32), pts, mask


def noisy_loop_graph(n_nodes: int = 1024):
    """A loop pose graph with 25% loop edges whose measurements carry 1 cm
    of noise, so the optimum cost is well above zero."""
    import jax.numpy as jnp

    from roborts_slam.parallel.multihost import make_synthetic_loop_graph

    data = make_synthetic_loop_graph(n_nodes, noise=0.05, loop_frac=0.25)
    rng = np.random.default_rng(1)
    return data._replace(edge_rel=data.edge_rel + jnp.asarray(
        rng.normal(0, 0.01, data.edge_rel.shape), jnp.float32))


# ---- phase 1 ---------------------------------------------------------------

def phase_parity(cfg):
    import jax
    import jax.numpy as jnp

    from roborts_slam.bench import cpu_reference as R
    from roborts_slam.bench.workload import headline_workload
    from roborts_slam.models.grid_map import world_to_map_pose
    from roborts_slam.ops import raycast
    from roborts_slam.ops.correlative import score_candidates
    from roborts_slam.ops.raster import scan_mark_image

    # correlative scores, each tier
    w = headline_workload()
    spec = w["fine_spec"]
    center = jnp.asarray(world_to_map_pose(w["offset"], spec.inv_res,
                                           w["init_pose"]))
    probs_np = np.asarray(w["fine_probs"])
    for name in ("coarse", "fine", "super_fine"):
        p = getattr(w["matcher"], name)
        fn = jax.jit(lambda pr, c, p=p: score_candidates(
            spec, p, pr, w["offset"], w["points"], w["mask"], w["n_valid"],
            c))
        s, a, xs, ys = jax.device_get(fn(w["fine_probs"], center))
        rs, ra, rxs, rys = R.score_candidates_serial(
            probs_np, spec.default_prob, spec.inv_res,
            np.asarray(w["points"]), int(w["n_valid"]), np.asarray(center),
            p.search_space_size, p.search_space_resolution,
            p.search_angle_offset, p.search_angle_resolution,
            p.use_point_size)
        err = float(np.abs(s - rs).max())
        n_off = int((np.abs(s - rs) > SCORE_ATOL).sum())
        log(f"[1] scores {name:10s} {s.shape}: max|err| {err:.3e} "
            f"({n_off} of {s.size} candidates over {SCORE_ATOL}), "
            f"grid max|err| {float(np.abs(xs - rxs).max()):.1e}")
        check(err <= SCORE_ATOL, f"{name} scores off by {err}")
        check(float(np.abs(a - ra).max()) < 1e-6, f"{name} angles differ")

    # mark image and bad-ray count on a willow-sized pub map
    lrange = 10.0
    world = cfg.derived_world_size(lrange)
    pspec, cmap, pose, pts, mask = pub_workload(cfg, lrange, world)
    mark = np.asarray(jax.jit(
        lambda c, po, pt, m: scan_mark_image(pspec, c.offset, pt, m, po))(
            cmap, jnp.asarray(pose), jnp.asarray(pts), jnp.asarray(mask)))
    ref = R.mark_image_serial(pspec.height, pspec.width, pspec.inv_res,
                              np.asarray(cmap.offset), pose, pts, mask)
    n_diff = int((mark != ref).sum())
    log(f"[1] mark image {mark.shape}: {n_diff} cells differ "
        f"(free {int((ref == 1).sum())}, occupied {int((ref == 2).sum())})")
    check(n_diff == 0, f"mark image: {n_diff} cells differ")

    n_valid = int(mask.sum())
    tol = cfg.map_check_bound_tolerance
    thr_d2 = int(np.floor(tol * tol)) + 1

    @jax.jit
    def bad_count(c, po, pt, m):
        start, end, ok, _ = raycast.penalty_rays(
            pspec, c, pt, m, jnp.int32(n_valid), po, cfg.map_check_point_num)
        bad = raycast.bad_ray_count(
            pspec, c, start, end, ok, jnp.float32(cfg.map_min_passthrough),
            jnp.float32(cfg.map_occu_threshold), thr_d2)
        return start, end, ok, bad

    start, end, ok, bad = jax.device_get(bad_count(
        cmap, jnp.asarray(pose), jnp.asarray(pts), jnp.asarray(mask)))
    rstart, rends, rok = R.penalty_rays_serial(
        pspec.height, pspec.width, pspec.inv_res, np.asarray(cmap.offset),
        pose, pts, mask, n_valid, cfg.map_check_point_num)
    check(tuple(start) == tuple(rstart) and np.array_equal(end, rends)
          and np.array_equal(ok, rok), "penalty rays differ")
    rbad = R.bad_rays_serial(np.asarray(cmap.hits), np.asarray(cmap.passes),
                             rstart, rends, rok, cfg.map_min_passthrough,
                             cfg.map_occu_threshold, tol)
    log(f"[1] penalty bad rays: device {int(bad)}, reference {rbad} "
        f"of {int(rok.sum())} rays")
    check(int(bad) == rbad, "bad-ray count differs")

    # SPA solve on a ~1k-node loop graph vs float64 dense LM
    from roborts_slam.backend.spa import solve_pose_graph

    data = noisy_loop_graph()
    spa_against_float64("[1]", data, {
        f"1024 nodes / {data.edge_ij.shape[0]} edges":
            jax.device_get(solve_pose_graph(data))})

    # Gauss-Newton refine on a willow-scene coarse map vs float64
    from roborts_slam.frontend.matchers import MatcherParams
    from roborts_slam.models.grid_map import (make_prob_map,
                                              scan_match_map_specs)
    from roborts_slam.models.scan import scan_from_ranges
    from roborts_slam.io.simulate import raycast as sim_raycast
    from roborts_slam.ops.gauss_newton import optimize_scan_match
    from roborts_slam.ops.raster import stamp_scan_batch

    sc, gt = willow_scene()
    ys, xs = np.nonzero(gt.free)
    base = np.array([xs.mean() * gt.resolution, ys.mean() * gt.resolution])
    gposes = np.array([[base[0] + 0.3 * k, base[1], 0.05 * k]
                       for k in range(8)])
    P = cfg.max_points
    scans = [scan_from_ranges(sim_raycast(gt, q, sc.laser), sc.laser, q,
                              0.0, P) for q in gposes]
    cspec, _ = scan_match_map_specs(cfg, 30.0)
    coff = 0.5 * cspec.width * cspec.resolution - base
    cmap_gn = stamp_scan_batch(
        cspec, make_prob_map(cspec, coff.astype(np.float32)),
        jnp.stack([s.points for s in scans[:-1]]),
        jnp.stack([s.mask for s in scans[:-1]]),
        jnp.asarray(gposes[:-1], jnp.float32), jnp.ones(7, bool),
        use_blur=True)
    q = scans[-1]
    init = (gposes[-1] + [0.06, -0.04, 0.02]).astype(np.float32)
    op = MatcherParams.from_config(cfg).optimize
    res = jax.device_get(jax.jit(lambda pr, o, pt, m, p0: optimize_scan_match(
        cspec, op, pr, o, pt, m, p0))(cmap_gn.probs, cmap_gn.offset,
                                      q.points, q.mask, jnp.asarray(init)))
    rpose, rcost = R.optimize_scan_match_serial(
        np.asarray(cmap_gn.probs), cspec.inv_res, np.asarray(cmap_gn.offset),
        np.asarray(q.points), np.asarray(q.mask), init,
        op.iterate_max_times, op.cost_decrease_threshold,
        op.cost_min_threshold, op.max_update_distance, op.max_update_angle)
    dpos = float(np.abs(np.asarray(res.pose[:2], np.float64)
                        - rpose[:2]).max())
    log(f"[1] Gauss-Newton refine: max|dxy| {dpos:.2e} m, |dth| "
        f"{abs(float(res.pose[2]) - rpose[2]):.2e} rad, cost "
        f"{float(res.cost):.4f} vs {rcost:.4f}")
    check(dpos <= GN_POS_TOL, f"Gauss-Newton pose off by {dpos} m")


# ---- phase 2 ---------------------------------------------------------------

def _angle_diff(a, b):
    return np.abs(np.arctan2(np.sin(a - b), np.cos(a - b)))


def phase_golden(cfg):
    """Two checks per golden (tests/data/golden_{icra,willow}.npz).

    Free replay: the card replays the log through ``SlamEngine`` and must
    make the decisions the recording CPU made (kept set, links, loop
    closures). Its poses are printed against the golden, not bounded: the
    matcher averages the candidates within a fixed tolerance of the best
    score, so a ~1e-6 m difference in the state can move a candidate
    across that edge and the pose by a fraction of the 1 cm grid, and the
    difference is carried into every later map stamp.

    Lockstep: the CPU replays the golden itself, and before every scan its
    front-end state is copied to the card, which takes the same step. Each
    step's pose must agree with the CPU's within the golden's own
    tolerance (tests/test_golden.py, 2e-3 m and rad), and so must the keep
    decision."""
    import jax
    import jax.numpy as jnp

    from roborts_slam.frontend.processor import frontend_step
    from roborts_slam.models.scan import LaserModel, ranges_to_packed
    from tools.make_golden import build_engine

    tol = 2e-3                        # tests/test_golden.py POS_TOL/ANG_TOL
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    step = jax.jit(frontend_step, static_argnums=0)
    for scene in ("icra", "willow"):
        g = np.load(os.path.join(REPO, "tests", "data",
                                 f"golden_{scene}.npz"))
        laser = LaserModel.from_array(g["laser"])
        n = g["ranges"].shape[0]
        engine = build_engine(laser, scene)
        kept = [i for i in range(n)
                if engine.process(g["ranges"][i], g["odom"][i],
                                  float(g["times"][i]))]
        traj, exp = engine.trajectory_array(), g["trajectory"]
        same_kept = kept == list(g["kept_ids"])
        links, loops = engine.backend.num_links, engine.backend.num_loop_closures
        log(f"[2] golden {scene}: kept {len(kept)}/{len(g['kept_ids'])} "
            f"same set {same_kept}, links {links}/{int(g['links'])}, "
            f"loops {loops}/{int(g['loops'])}")
        check(same_kept, f"golden {scene}: kept set differs")
        check(links == int(g["links"]) and loops == int(g["loops"]),
              f"golden {scene}: graph counts differ")
        dpos = np.abs(traj[:, 1:3] - exp[:, 1:3]).max(1)
        dth = _angle_diff(traj[:, 3], exp[:, 3])
        log(f"[2] golden {scene} free replay: max|dxy| {dpos.max():.2e} m, "
            f"max|dth| {dth.max():.2e} rad; "
            f"{int(((dpos >= tol) | (dth >= tol)).sum())} of {len(dpos)} "
            f"poses beyond {tol}; per kept scan (m): "
            f"{' '.join(f'{d:.1e}' for d in dpos)}")

        with jax.default_device(cpu):
            ref = build_engine(laser, scene)
        steps_xy, steps_th, n_decisions = [], [], 0
        for i in range(n):
            pts, msk, nv = ranges_to_packed(g["ranges"][i], laser,
                                            ref.config.max_points)
            args = (pts, msk, np.int32(nv), g["odom"][i].astype(np.float32))
            _, on_cpu = step(ref.fspec, ref.state,
                             *jax.device_put(args, cpu))
            _, on_gpu = step(ref.fspec, jax.device_put(ref.state, gpu),
                             *jax.device_put(args, gpu))
            on_cpu, on_gpu = jax.device_get((on_cpu, on_gpu))
            steps_xy.append(np.abs(on_gpu.pose[:2] - on_cpu.pose[:2]).max())
            steps_th.append(_angle_diff(on_gpu.pose[2], on_cpu.pose[2]))
            n_decisions += bool(on_gpu.map_updated) != bool(on_cpu.map_updated)
            with jax.default_device(cpu):
                ref.process(g["ranges"][i], g["odom"][i], float(g["times"][i]))
        ref_traj = ref.trajectory_array()
        check(ref_traj.shape == exp.shape
              and np.abs(ref_traj[:, 1:] - exp[:, 1:]).max() < tol,
              f"golden {scene}: the CPU replay left the golden")
        sx, st = np.asarray(steps_xy), np.asarray(steps_th)
        log(f"[2] golden {scene} lockstep, {n} steps from the CPU's state: "
            f"max|dxy| {sx.max():.2e} m, max|dth| {st.max():.2e} rad, "
            f"{int((sx > 1e-5).sum())} steps over 1e-5 m, "
            f"{n_decisions} keep decisions differ")
        check(sx.max() < tol and st.max() < tol and n_decisions == 0,
              f"golden {scene}: a front-end step on the card left the CPU's")


# ---- phase 3 ---------------------------------------------------------------

def phase_end_to_end(cfg, device_kind: str):
    import jax

    from roborts_slam.engine import SlamEngine
    from roborts_slam.io.scenes import willow_block_loop
    from roborts_slam.io.simulate import (path_to_trajectory, plan_loop_path,
                                          simulate_log)
    from roborts_slam.utils.evaluation import ate_rmse, match_by_time

    compile_s = []
    jax.monitoring.register_event_duration_secs_listener(
        lambda name, secs, **kw: compile_s.append(secs)
        if name.endswith("backend_compile_duration") else None)

    sc, gt = willow_scene()
    t0 = time.perf_counter()
    # the corridor loop around one office block, driven once and on for a
    # fifth of a lap so the return to the start can close the loop
    path = plan_loop_path(gt, willow_block_loop(), clearance_m=sc.clearance_m)
    path = np.concatenate([path, path[1:len(path) // 5]])
    log_ = simulate_log(gt, sc.laser,
                        trajectory=path_to_trajectory(path, speed=sc.speed),
                        odom_error=sc.odom_error, range_noise=0.005, seed=0)
    log(f"[3] simulated willow block loop: {len(log_)} scans of "
        f"{sc.laser.num_beams} beams in {time.perf_counter() - t0:.1f} s")

    engine = SlamEngine(cfg, log_.laser, synchronous_backend=True)
    fs = engine.fspec
    log(f"[3] world {engine.world_size:.1f} m: fine map "
        f"{fs.fine_spec.height}x{fs.fine_spec.width} @ "
        f"{fs.fine_spec.resolution} m, pub {fs.pub_spec.height}x"
        f"{fs.pub_spec.width} @ {fs.pub_spec.resolution} m")
    t0 = time.perf_counter()
    for i in range(len(log_)):
        engine.process(log_.ranges[i], log_.odom[i], float(log_.times[i]))
    engine.finish()
    wall = time.perf_counter() - t0
    traj = engine.trajectory_array()
    est, gtm = match_by_time(traj, log_.gt_poses, log_.times)
    ate = float(ate_rmse(est, gtm))
    loops = engine.backend.num_loop_closures
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[3] {device_kind}: fed {len(log_)} scans, kept {len(traj)}, "
        f"links {engine.backend.num_links}, loop closures {loops}")
    log(f"[3] ATE {ate:.4f} m (bound {E2E_ATE_BOUND}); wall {wall:.1f} s, "
        f"of which compile {sum(compile_s):.1f} s in {len(compile_s)} "
        f"compiles; peak_bytes_in_use {peak}")
    for line in engine.timers.report().splitlines():
        log(f"[3]   {line}")
    check(loops >= 1, "no loop closure")
    check(ate <= E2E_ATE_BOUND, f"ATE {ate} m over {E2E_ATE_BOUND}")


# ---- phase 4 ---------------------------------------------------------------

def phase_timing(cfg, card: str):
    import jax
    import jax.numpy as jnp

    from roborts_slam.bench.timing import time_call
    from roborts_slam.bench.workload import headline_workload
    from roborts_slam.models.grid_map import world_to_map_pose
    from roborts_slam.ops.correlative import score_candidates
    from roborts_slam.ops.raster import scan_mark_image
    from roborts_slam.ops.raycast import map_feedback_penalty

    w = headline_workload()
    spec = w["fine_spec"]
    center = jnp.asarray(world_to_map_pose(w["offset"], spec.inv_res,
                                           w["init_pose"]))
    rows = []
    for name in ("coarse", "fine", "super_fine"):
        p = getattr(w["matcher"], name)
        fn = jax.jit(lambda pr, c, p=p: score_candidates(
            spec, p, pr, w["offset"], w["points"], w["mask"], w["n_valid"],
            c)[0])
        n_cand = p.n_angles * p.n_space ** 2
        rows.append((f"score {name} ({n_cand} candidates, "
                     f"{p.use_point_size}-point sample)",
                     time_call(fn, w["fine_probs"], center, reps=30)))
        if name == "coarse":
            mem = fn.lower(w["fine_probs"], center).compile() \
                .memory_analysis()
            log(f"[4] memory_analysis (coarse scoring): peak "
                f"{getattr(mem, 'peak_memory_in_bytes', None)}, temp "
                f"{getattr(mem, 'temp_size_in_bytes', None)}")

    lrange = 10.0
    pspec, cmap, pose, pts, mask = pub_workload(
        cfg, lrange, cfg.derived_world_size(lrange))
    pose, pts, mask = jnp.asarray(pose), jnp.asarray(pts), jnp.asarray(mask)
    mark = jax.jit(lambda c, po: scan_mark_image(pspec, c.offset, pts, mask,
                                                 po))
    rows.append((f"mark image ({pspec.height}x{pspec.width}, 1081 beams x "
                 f"{pspec.max_ray_cells} cells)", time_call(mark, cmap, pose, reps=30)))
    pen = jax.jit(lambda c, po: map_feedback_penalty(
        pspec, c, pts, mask, jnp.int32(1081), po, cfg.map_check_point_num,
        cfg.map_check_bound_tolerance, cfg.map_check_penalty_gain,
        jnp.float32(cfg.map_min_passthrough),
        jnp.float32(cfg.map_occu_threshold)))
    rows.append((f"penalty ({cfg.map_check_point_num} rays)",
                 time_call(pen, cmap, pose, reps=30)))
    for label, t in rows:
        log(f"[4] {card}: {label}: median {t['median'] * 1e6:.1f} us, "
            f"best {t['best'] * 1e6:.1f} us")


# ---- phase 5 ---------------------------------------------------------------

def spa_against_float64(tag: str, data, solves, cap: int = 50):
    """Each float32 solve in ``solves`` ({name: (poses, cost, iterations)})
    against the float64 dense LM optimum of ``data``. Poses are held to the
    optimum in the problem's own metric: the float64 cost at a solve's
    poses may exceed the optimum by ``SPA_REL_COST``, relative. The
    Euclidean distance is printed: the float32 cost cannot resolve the
    loop's softest directions, where LM creeps on at a cost that hardly
    falls and often stops at its iteration cap ``cap``."""
    from roborts_slam.bench import cpu_reference as R

    rposes, rcost = R.solve_pose_graph_serial(
        data.poses, data.edge_ij, data.edge_rel, data.edge_info)
    for name, (poses, _, iters) in solves.items():
        cost = R.spa_cost_serial(poses, data.edge_ij, data.edge_rel,
                                 data.edge_info)
        excess = (cost - rcost) / rcost
        dxy = float(np.abs(np.asarray(poses[:, :2], np.float64)
                           - rposes[:, :2]).max())
        log(f"{tag} SPA {name}: {int(iters)} of at most {cap} iterations, "
            f"float64 cost at its "
            f"poses {cost:.7f} vs optimum {rcost:.7f} (excess {excess:.2e}), "
            f"max|dxy| to the optimum {dxy:.2e} m")
        check(excess <= SPA_REL_COST, f"SPA {name}: cost excess {excess}")


def chain_match_workload(n_chains: int):
    """Chain matching on willow content: a store of every 4th scan of the
    block loop at its true pose, ``n_chains`` chains of 16 stored scans
    around one query scan, each chain started from a perturbed pose.
    Returns (BackendSpec, operands of chain_match_batch_gather, the query's
    true pose)."""
    import jax.numpy as jnp

    from roborts_slam.backend.processor import BackendSpec
    from roborts_slam.config import (SIMULATION_REFERENCE_PROFILE,
                                     load_config)
    from roborts_slam.io.scenes import willow_block_loop
    from roborts_slam.io.simulate import (path_to_trajectory, plan_loop_path,
                                          simulate_log)
    from roborts_slam.models.grid_map import pub_map_spec
    from roborts_slam.models.scan import ranges_to_packed

    cfg = load_config(SIMULATION_REFERENCE_PROFILE)
    sc, gt = willow_scene()
    path = plan_loop_path(gt, willow_block_loop(), clearance_m=sc.clearance_m)
    traj = path_to_trajectory(path, speed=sc.speed)[:256:4]
    slog = simulate_log(gt, sc.laser, trajectory=traj, range_noise=0.005,
                        seed=0)
    packed = [ranges_to_packed(r, sc.laser, cfg.max_points)
              for r in slog.ranges]
    K, q = cfg.max_chain_scans, 40
    ids = np.full((n_chains, K), -1, np.int32)
    for b in range(n_chains):
        chain = [i for i in range(3 * b, 3 * b + K + 1) if i != q][:K]
        ids[b, :len(chain)] = chain
    rng = np.random.default_rng(7)
    inits = slog.gt_poses[q] + rng.uniform(-0.05, 0.05,
                                           (n_chains, 3)) * [1, 1, 0.5]
    pub = pub_map_spec(cfg, sc.laser.range_max, 50.0)
    poses = jnp.asarray(slog.gt_poses, jnp.float32)
    args = (jnp.asarray(np.stack([p[0] for p in packed])),
            jnp.asarray(np.stack([p[1] for p in packed])),
            jnp.asarray(np.array([p[2] for p in packed], np.int32)),
            poses, jnp.asarray(ids), jnp.int32(q),
            jnp.asarray(inits, jnp.float32), poses[q],
            jnp.zeros((pub.height, pub.width), jnp.float32),
            jnp.zeros((pub.height, pub.width), jnp.float32),
            jnp.asarray([25.0, 25.0], jnp.float32) - poses[q, :2])
    return (BackendSpec.from_config(cfg, sc.laser.range_max, pub), args,
            slog.gt_poses[q])


def compare_chain_results(label: str, single, other) -> None:
    """(poses, scores, covs) of one chain batch computed two ways. Float32
    reductions compile in another order for another batch layout, so
    scores may move by rounding and poses by ~1e-3 of a cell. Each
    covariance entry is held to ``CHAIN_COV_REL`` of sqrt(var_i var_j), the
    scale of that entry in its own matrix: such a shift moves a variance
    by a few 1e-3 of itself at most."""
    tols = {"pose": 1e-4, "score": 1e-5}
    for name, a, b in zip(("pose", "score", "cov"), single, other):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = np.abs(a - b)
        if name == "cov":
            sd = np.sqrt(np.abs(np.diagonal(a, axis1=1, axis2=2)))
            rel = err / np.maximum(sd[:, :, None] * sd[:, None, :], 1e-30)
            log(f"[5] {label}: cov max|diff| {err.max():.2e}, relative to "
                f"sqrt(var_i var_j) {rel.max():.2e} (bound {CHAIN_COV_REL})")
            check(rel.max() <= CHAIN_COV_REL, f"{label}: covariances differ")
        else:
            log(f"[5] {label}: {name} max|diff| {err.max():.2e}")
            check(err.max() <= tols[name], f"{label}: {name} differs")


def phase_four_cards():
    import jax

    from roborts_slam.backend.processor import chain_match_batch_gather
    from roborts_slam.backend.spa import solve_pose_graph
    from roborts_slam.parallel.dist_spa import solve_pose_graph_sharded
    from roborts_slam.parallel.mesh import make_mesh
    from roborts_slam.parallel.sharded_match import (
        make_sharded_chain_matcher_gather,
    )

    n_dev = len(jax.devices())
    data = noisy_loop_graph()
    single = jax.device_get(solve_pose_graph(data))
    sharded = jax.device_get(solve_pose_graph_sharded(
        data, make_mesh(axis_name="graph"), axis="graph"))
    spa_against_float64("[5]", data, {"single device": single,
                               f"edge-sharded over {n_dev} devices": sharded})
    log(f"[5] SPA sharded vs single: max|dxy| "
        f"{float(np.abs(single[0][:, :2] - sharded[0][:, :2]).max()):.2e} m")

    bspec, args, truth = chain_match_workload(2 * n_dev)
    single = jax.device_get(chain_match_batch_gather(bspec, *args))
    sharded = jax.device_get(make_sharded_chain_matcher_gather(
        bspec, make_mesh(axis_name="data"))(*args))
    log(f"[5] chain scores {float(single[1].min()):.3f}.."
        f"{float(single[1].max()):.3f}, max|pose - truth| "
        f"{float(np.abs(single[0][:, :2] - truth[:2]).max()):.4f} m")
    compare_chain_results(
        f"sharded chain matcher, {2 * n_dev} chains over {n_dev} devices, "
        f"vs single device", single, sharded)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU phase")
    args = ap.parse_args()

    device = phase_device()
    t_all = time.perf_counter()
    try:
        if args.four_cards:
            check(device["count"] >= 4,
                  f"--four-cards needs 4 GPUs, JAX sees {device['count']}")
            phase_four_cards()
        else:
            from roborts_slam.config import (SIMULATION_REFERENCE_PROFILE,
                                             load_config)

            cfg = load_config(SIMULATION_REFERENCE_PROFILE)
            for name, fn in (("parity", lambda: phase_parity(cfg)),
                             ("golden", lambda: phase_golden(cfg)),
                             ("end-to-end", lambda: phase_end_to_end(
                                 cfg, device["kind"])),
                             ("timing", lambda: phase_timing(
                                 cfg, device["card"]))):
                t0 = time.perf_counter()
                fn()
                log(f"phase {name} passed in {time.perf_counter() - t0:.1f} s")
    except CheckFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)


if __name__ == "__main__":
    main()
