"""Front-end SLAM step as one pure jitted function.

Replacement for ``SlamProcessor::process``
(src/slam/slam_processor.cpp:65-247). The reference's mutable maps + mutexes
become an explicit immutable ``FrontendState`` pytree threaded through a
single jitted step: predict → 3-tier match → map-consistency penalty →
accept gate → map updates, with all data-dependent gates as ``where``/``cond``
so one device dispatch handles a scan end to end. Buffer donation updates
the map arrays in place.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp

from ..config import SlamConfig
from ..models.grid_map import CountMap, CountMapSpec, ProbMap, ProbMapSpec
from ..ops.raster import stamp_scan, update_count_map
from ..ops.raycast import map_feedback_penalty
from ..utils.geometry import predict_pose_by_odom
from .matchers import MatcherParams, scan_match


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    config: SlamConfig
    pub_spec: CountMapSpec
    coarse_spec: ProbMapSpec
    fine_spec: ProbMapSpec
    matcher: MatcherParams
    # windowed-match map specs (use_running_range_scan_match): sized like the
    # back-end chain maps, rebuilt from the running window around each scan
    window_coarse_spec: ProbMapSpec | None = None
    window_fine_spec: ProbMapSpec | None = None

    @staticmethod
    def from_config(config: SlamConfig, laser_range_max: float,
                    world_size: float | None = None) -> "FrontendSpec":
        from ..models.grid_map import (
            backend_map_specs, pub_map_spec, scan_match_map_specs,
        )

        if world_size is None:
            world_size = config.derived_world_size(laser_range_max)
        coarse, fine = scan_match_map_specs(config, world_size)
        wcoarse = wfine = None
        if config.use_running_range_scan_match:
            wcoarse, wfine = backend_map_specs(config, laser_range_max)
        return FrontendSpec(
            config=config,
            pub_spec=pub_map_spec(config, laser_range_max, world_size),
            coarse_spec=coarse,
            fine_spec=fine,
            matcher=MatcherParams.from_config(config),
            window_coarse_spec=wcoarse,
            window_fine_spec=wfine,
        )

    def world_size(self) -> float:
        return self.pub_spec.height * self.pub_spec.resolution


class FrontendState(NamedTuple):
    pub: CountMap
    coarse: ProbMap
    fine: ProbMap
    pose: jnp.ndarray                 # (3,) current sensor pose (world)
    last_map_update_pose: jnp.ndarray  # (3,)
    map_penalize_times: jnp.ndarray   # () int32
    scan_index: jnp.ndarray           # () int32 = current_data_index
    # odometry of the last KEPT scan, carried ON DEVICE so a step's
    # prediction never depends on the previous step's fetched result —
    # the prerequisite for the double-buffered fetch pipeline (the host
    # used to supply this, forcing a blocking summary fetch per scan)
    last_kept_odom: jnp.ndarray       # (3,)
    # timestamp of the last scan that PASSED the move gate (the host's
    # _last_process_time, device-resident so the MoveEnough check can run
    # in-program with zero lag — the pipelined host-side check compared
    # against stale odometry and diverged the kept set on
    # rejection-heavy scenes)
    last_step_time: jnp.ndarray       # () f32


class StepInfo(NamedTuple):
    pose: jnp.ndarray         # (3,) pose assigned to this scan
    score: jnp.ndarray        # () penalized scan-match score
    cov: jnp.ndarray          # (3,3)
    map_updated: jnp.ndarray  # () bool — scan kept (added to store + backend)
    pose_accepted: jnp.ndarray  # () bool — pose gate passed


def pack_step_summary(info: StepInfo) -> jnp.ndarray:
    """StepInfo flattened to ONE (15,) f32 vector: pose(3) + cov(9) +
    [map_updated, pose_accepted, score]. The engine fetches exactly this
    per scan — fetching the tuple leaves separately costs one device
    round-trip EACH."""
    return jnp.concatenate([
        info.pose.astype(jnp.float32),
        info.cov.reshape(-1).astype(jnp.float32),
        jnp.stack([info.map_updated.astype(jnp.float32),
                   info.pose_accepted.astype(jnp.float32),
                   info.score.astype(jnp.float32)]),
    ])


def init_frontend_state(spec: FrontendSpec) -> FrontendState:
    """Maps centered on the start pose, reference map-offset convention
    (CreateAllMap, slam_processor.cpp:468-471: offset = init_map_size *
    map_offset_{x,y}, i.e. world origin at the map center). Offsets derive
    from each map's own extent, so windowed scan-match maps
    (config.match_map_window) start centered too."""
    from ..models.grid_map import make_count_map, make_prob_map

    cfg = spec.config
    # distinct offset buffers per map: buffer donation forbids aliased inputs
    def off(mspec):
        ex = mspec.width * mspec.resolution
        ey = mspec.height * mspec.resolution
        return jnp.array([ex * cfg.map_offset_x, ey * cfg.map_offset_y],
                         jnp.float32)
    return FrontendState(
        pub=make_count_map(spec.pub_spec, off(spec.pub_spec)),
        coarse=make_prob_map(spec.coarse_spec, off(spec.coarse_spec)),
        fine=make_prob_map(spec.fine_spec, off(spec.fine_spec)),
        pose=jnp.zeros(3, jnp.float32),
        last_map_update_pose=jnp.full((3,), 3.4e38, jnp.float32),
        map_penalize_times=jnp.int32(0),
        scan_index=jnp.int32(0),
        last_kept_odom=jnp.zeros(3, jnp.float32),
        last_step_time=jnp.float32(-3.4e38),
    )


def frontend_step(spec: FrontendSpec, state: FrontendState,
                  points, mask, n_valid, cur_odom, cur_time=None
                  ) -> tuple[FrontendState, StepInfo]:
    """One scan through the front end (slam_processor.cpp:65-247), matching
    against the accumulated scan-match maps (the reference's default path).
    The last-kept odometry lives in ``state`` (device-resident), so steps
    chain without any host round-trip between them."""
    return _frontend_core(
        spec, state,
        spec.fine_spec, state.fine, spec.coarse_spec, state.coarse,
        points, mask, n_valid, cur_odom, cur_time)


def frontend_step_windowed(spec: FrontendSpec, state: FrontendState,
                           win_points, win_masks, win_poses, win_valid,
                           points, mask, n_valid, cur_odom, cur_time=None
                           ) -> tuple[FrontendState, StepInfo]:
    """Windowed variant (use_running_range_scan_match): the match maps are
    rebuilt from the running-range window scans, recentered on the odometry
    prediction — the reference's disabled windowed path
    (slam_processor.cpp:134-159) built the same maps via
    ResetScanMatchMapWithRangeVec (:448-462). The persistent maps are still
    updated normally afterwards (UpdateMap runs on all maps either way)."""
    from ..models.grid_map import make_prob_map
    from ..ops.raster import stamp_scan_batch

    cfg = spec.config
    if cfg.use_odometry:
        last_odom = jnp.where(state.scan_index == 0, cur_odom,
                              state.last_kept_odom)
        predict = predict_pose_by_odom(state.pose, last_odom, cur_odom)
    else:
        predict = state.pose

    def window_map(pspec):
        size_x = pspec.width * pspec.resolution
        size_y = pspec.height * pspec.resolution
        off = jnp.stack([-(predict[0] - 0.5 * size_x),
                         -(predict[1] - 0.5 * size_y)])
        return make_prob_map(pspec, off)

    wfine = stamp_scan_batch(spec.window_fine_spec,
                             window_map(spec.window_fine_spec),
                             win_points, win_masks, win_poses, win_valid,
                             use_blur=cfg.fine_map_use_blur)
    wcoarse = stamp_scan_batch(spec.window_coarse_spec,
                               window_map(spec.window_coarse_spec),
                               win_points, win_masks, win_poses, win_valid,
                               use_blur=cfg.coarse_map_use_blur)
    return _frontend_core(
        spec, state,
        spec.window_fine_spec, wfine, spec.window_coarse_spec, wcoarse,
        points, mask, n_valid, cur_odom, cur_time)


def _frontend_core(spec: FrontendSpec, state: FrontendState,
                   match_fine_spec: ProbMapSpec, match_fine: ProbMap,
                   match_coarse_spec: ProbMapSpec, match_coarse: ProbMap,
                   points, mask, n_valid, cur_odom, cur_time=None
                   ) -> tuple[FrontendState, StepInfo]:
    """Shared front-end step: predict → match (against the given maps) →
    penalty → gates → persistent map updates. With ``cur_time`` the
    MoveEnough gate (slam_processor.cpp:604-616) ALSO runs in-program
    against the device-resident last-kept odometry — exact even when the
    host dispatches ahead of its fetches (the pipelined mode dispatches
    every scan and lets this gate drop the unmoved ones)."""
    cfg = spec.config
    is_first = state.scan_index == 0

    if (cur_time is not None and cfg.use_odometry and cfg.use_move_check):
        dt_pass = (cur_time - state.last_step_time) > cfg.move_time_threshold
        d = cur_odom[:2] - state.last_kept_odom[:2]
        dist_pass = jnp.hypot(d[0], d[1]) >= cfg.move_distance_threshold
        dth = cur_odom[2] - state.last_kept_odom[2]
        ang_pass = jnp.abs(jnp.arctan2(jnp.sin(dth), jnp.cos(dth))) \
            >= cfg.move_angle_threshold
        move_ok = is_first | dt_pass | dist_pass | ang_pass
    else:
        move_ok = jnp.bool_(True)

    # --- predict (slam_processor.cpp:122-126) ---
    if cfg.use_odometry:
        # first scan: no kept odom yet -> zero delta (the engine's host
        # fallback ``last_odom = odom`` reproduced in-program)
        last_odom = jnp.where(is_first, cur_odom, state.last_kept_odom)
        predict = predict_pose_by_odom(state.pose, last_odom, cur_odom)
    else:
        predict = state.pose

    # --- scan match (:133-149) — skipped for the first scan (:120) ---
    out = scan_match(
        spec.matcher,
        match_fine_spec, match_fine.probs, match_fine.offset,
        match_coarse_spec, match_coarse.probs, match_coarse.offset,
        points, mask, n_valid, predict,
    )

    # --- map-consistency penalty (:167-178, MapCheckPenalize :573-595) ---
    if cfg.use_map_check_feedback:
        penalty = map_feedback_penalty(
            spec.pub_spec, state.pub, points, mask, n_valid, out.pose,
            cfg.map_check_point_num, cfg.map_check_bound_tolerance,
            cfg.map_check_penalty_gain,
            min_passthrough=jnp.float32(cfg.map_min_passthrough),
            occu_threshold=jnp.float32(cfg.map_occu_threshold),
        )
    else:
        penalty = jnp.float32(1.0)

    apply_pen = state.map_penalize_times < 5
    score = jnp.where(apply_pen,
                      jnp.minimum(out.score * penalty, 1.0), out.score)
    pen_times = jnp.where(
        apply_pen,
        jnp.where(penalty < 0.7, state.map_penalize_times + 1, 0),
        0,
    )

    # --- pose accept gate (:182-186); a move-gated scan changes nothing ---
    accept = (score > jnp.maximum(0.5, cfg.map_update_score_threshold)) \
        & move_ok
    pose = jnp.where(is_first, state.pose, jnp.where(accept, out.pose, state.pose))
    score = jnp.where(is_first, jnp.float32(1.0), score)

    # --- map update gate (UpdateMap, slam_processor.cpp:529-571) ---
    from ..utils.geometry import pose_change_enough

    moved = pose_change_enough(pose, state.last_map_update_pose,
                               cfg.map_update_distance_threshold,
                               cfg.map_update_angle_threshold)
    gate = (score > cfg.map_update_score_threshold) & (
        moved | (not cfg.use_map_update_move_check)
    )
    gate = (gate | (state.scan_index < 1)) & move_ok
    gate = gate | is_first

    # pub map factors: the first scan is trusted (slam_processor.cpp:540-552)
    free_f = jnp.where(is_first, jnp.float32(cfg.map_min_passthrough),
                       jnp.float32(cfg.map_update_free_factor))
    occu_f = jnp.where(is_first, jnp.float32(cfg.map_min_passthrough * 2.0),
                       jnp.float32(cfg.map_update_occu_factor))

    new_pub = update_count_map(spec.pub_spec, state.pub, points, mask, pose,
                               free_f, occu_f)
    new_coarse = stamp_scan(spec.coarse_spec, state.coarse, points, mask, pose,
                            use_blur=cfg.coarse_map_use_blur)
    new_fine = stamp_scan(spec.fine_spec, state.fine, points, mask, pose,
                          use_blur=cfg.fine_map_use_blur)

    sel = lambda new, old: jnp.where(gate, new, old)
    new_state = FrontendState(
        pub=CountMap(sel(new_pub.hits, state.pub.hits),
                     sel(new_pub.passes, state.pub.passes), state.pub.offset),
        coarse=ProbMap(sel(new_coarse.probs, state.coarse.probs), state.coarse.offset),
        fine=ProbMap(sel(new_fine.probs, state.fine.probs), state.fine.offset),
        pose=pose,
        last_map_update_pose=jnp.where(gate, pose, state.last_map_update_pose),
        map_penalize_times=jnp.where(
            is_first, 0,
            jnp.where(move_ok, pen_times,
                      state.map_penalize_times)).astype(jnp.int32),
        scan_index=state.scan_index + gate.astype(jnp.int32),
        # the engine keeps a scan (and its odom) iff the map-update gate
        # passed (engine reads summary[12] = map_updated as "accepted")
        last_kept_odom=jnp.where(gate, cur_odom.astype(jnp.float32),
                                 state.last_kept_odom),
        last_step_time=(jnp.where(move_ok,
                                  jnp.float32(cur_time),
                                  state.last_step_time)
                        if cur_time is not None else state.last_step_time),
    )
    info = StepInfo(pose=pose, score=score, cov=out.cov, map_updated=gate,
                    pose_accepted=accept | is_first)
    return new_state, info
