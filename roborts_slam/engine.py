"""SlamEngine — the top-level online SLAM driver.

Replacement for ``SlamNode`` + ``SlamProcessor`` orchestration
(src/roborts_slam_node.cpp, src/slam/slam_processor.cpp): consumes an
offline scan log (or live feed) scan by scan, runs the jitted front-end
step, maintains the scan store (the reference's SensorDataManager), and
drives the back-end (pose graph + loop closure) either synchronously or on
a worker thread (the reference's pipeline parallelism,
slam_processor.cpp:384-426).
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time as _time

import jax
import jax.numpy as jnp
import numpy as np

from .config import SlamConfig
from .backend.processor import Backend, BackendSpec
from .frontend.processor import (
    FrontendSpec, FrontendState, frontend_step, init_frontend_state,
    pack_step_summary,
)

from .models.scan import LaserModel, ranges_to_packed
from .ops.raster import rebuild_count_map, stamp_scan_batch
from .models.grid_map import CountMap, ProbMap, count_map_states
from .utils.profiling import StageTimers


def _store_append_impl(buf_pts, buf_msk, buf_nv, buf_poses,
                       pts, msk, nv, pose, i):
    """In-place append of one scan into the device store buffers (buffers
    donated: no O(capacity) copy per scan)."""
    return (jax.lax.dynamic_update_index_in_dim(buf_pts, pts, i, 0),
            jax.lax.dynamic_update_index_in_dim(buf_msk, msk, i, 0),
            buf_nv.at[i].set(nv),
            jax.lax.dynamic_update_index_in_dim(buf_poses, pose, i, 0))


_store_append = jax.jit(_store_append_impl, donate_argnums=(0, 1, 2, 3))
# async-backend variant: the worker thread may hold the CURRENT buffer
# handles between its device_arrays() snapshot and its chain-match
# dispatch; donating them there raises "Array has been deleted" under the
# worker (use-after-donate race). The copy costs ~10 MB on device — the
# same trade the non-donating fused step documents.
_store_append_nodonate = jax.jit(_store_append_impl)

# real copies (no donation → no input/output aliasing in XLA), one dispatch
_copy3 = jax.jit(lambda a, b, c: (jnp.copy(a), jnp.copy(b), jnp.copy(c)))


def _step_summary(spec, state, points, mask, n_valid, cur_odom):
    """frontend_step returning the packed (15,) summary instead of StepInfo
    (one host fetch per scan instead of three)."""
    state, info = frontend_step(spec, state, points, mask, n_valid, cur_odom)
    return state, pack_step_summary(info)


def _step_windowed_summary(spec, state, all_points, all_masks, all_poses,
                           win_ids, points, mask, n_valid, cur_odom):
    """Windowed front-end step with the running-range window gathered ON
    DEVICE from the store's resident buffers by id: the host ships a (W,)
    id vector instead of re-uploading (70, P, 2) host arrays per scan."""
    from .frontend.processor import frontend_step_windowed

    ids = jnp.maximum(win_ids, 0)
    valid = win_ids >= 0                                  # (W,)
    wp = all_points[ids]
    wm = all_masks[ids] & valid[:, None]
    wps = all_poses[ids]
    state, info = frontend_step_windowed(spec, state, wp, wm, wps, valid,
                                         points, mask, n_valid, cur_odom)
    return state, pack_step_summary(info)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("pub_spec", "coarse_spec", "fine_spec",
                                    "first_scan_extra", "coarse_blur",
                                    "fine_blur"))
def _rebuild_all_maps(pub_spec, coarse_spec, fine_spec,
                      pub_off, coarse_off, fine_off,
                      pts, msk, poses, valid, free_f, occu_f,
                      first_scan_extra: int, coarse_blur: bool,
                      fine_blur: bool):
    """The full CorrectPoseAndMap rebuild (pub + coarse + fine,
    slam_processor.cpp:350-366) as ONE jitted program. Called eagerly these
    stamps execute op-by-op, each its own small compile, which stalls the
    first loop closure of every process."""
    pub = rebuild_count_map(pub_spec, pub_off, pts, msk, poses, valid,
                            free_f, occu_f, first_scan_extra=first_scan_extra)
    coarse = stamp_scan_batch(
        coarse_spec,
        ProbMap(jnp.full((coarse_spec.height, coarse_spec.width),
                         coarse_spec.default_prob, jnp.float32),
                jnp.asarray(coarse_off, jnp.float32)),
        pts, msk, poses, valid, use_blur=coarse_blur)
    fine = stamp_scan_batch(
        fine_spec,
        ProbMap(jnp.full((fine_spec.height, fine_spec.width),
                         fine_spec.default_prob, jnp.float32),
                jnp.asarray(fine_off, jnp.float32)),
        pts, msk, poses, valid, use_blur=fine_blur)
    return pub, coarse, fine


_rebuild_pub_jit = jax.jit(rebuild_count_map,
                           static_argnames=("spec", "first_scan_extra"))


@_partial(jax.jit, static_argnames=("coarse_spec", "fine_spec",
                                    "coarse_blur", "fine_blur"))
def _stamp_match_maps(coarse_spec, fine_spec, coarse_off, fine_off,
                      pts, msk, poses, valid, coarse_blur: bool,
                      fine_blur: bool):
    """Fresh coarse+fine match maps stamped from a scan batch in one
    program (the rolling-window recenter path)."""
    coarse = stamp_scan_batch(
        coarse_spec,
        ProbMap(jnp.full((coarse_spec.height, coarse_spec.width),
                         coarse_spec.default_prob, jnp.float32),
                jnp.asarray(coarse_off, jnp.float32)),
        pts, msk, poses, valid, use_blur=coarse_blur)
    fine = stamp_scan_batch(
        fine_spec,
        ProbMap(jnp.full((fine_spec.height, fine_spec.width),
                         fine_spec.default_prob, jnp.float32),
                jnp.asarray(fine_off, jnp.float32)),
        pts, msk, poses, valid, use_blur=fine_blur)
    return coarse, fine


class ScanStore:
    """Append-only store of accepted scans (SensorDataManager,
    src/slam/sensor_data_manager.h:349-595). One copy per scan in sensor-local
    meters — the reference's per-resolution scaled copies (:576-579) are
    replaced by on-the-fly scaling inside the kernels."""

    def __init__(self, max_points: int,
                 running_range_max_scans: int = 70,
                 running_range_max_distance: float = 5.0):
        # guards every mutation/snapshot against the async back-end worker
        # (device_arrays' whole-list numpy snapshots would otherwise race
        # the main thread's add())
        self._lock = threading.RLock()
        self.max_points = max_points
        # donation is only safe when exactly ONE thread touches the device
        # mirror (sync engine); the async engine clears this so appends
        # copy instead of invalidating handles a worker dispatch may hold
        self.donate_appends = True
        self._points: list[np.ndarray] = []
        self._masks: list[np.ndarray] = []
        self._n_valid: list[int] = []
        self._centroids: list[np.ndarray] = []   # local-frame point centroid
        self._local_bboxes: list[tuple] = []     # (min_xy, max_xy) local
        self.poses: list[np.ndarray] = []        # world poses (mutable on correction)
        self.odoms: list[np.ndarray] = []
        self.times: list[float] = []
        self.pose_version = 0                    # bumped by every set_pose
        # (pub_spec, hits, passes, offset) — ONE atomic tuple so the async
        # back-end worker always pairs arrays with the spec they were built
        # under (the pub map can grow mid-run, _grow_pub_to)
        self._pub_arrays = None
        # incremental barycenter cache: O(1) append, invalidated only by
        # pose corrections (the round-1 version rebuilt the full (N, 3)
        # array from python lists on every back-end call — O(N) per scan,
        # O(N^2) per run)
        self._bary = np.zeros((256, 3), np.float64)
        self._bary_dirty_from = 0
        # running-range sliding window (UpdateRunningRange,
        # sensor_data_manager.h:540-558): most recent scan ids bounded by
        # count and by span of their sensor x/y positions
        self.running_range_max_scans = running_range_max_scans
        self.running_range_max_distance = running_range_max_distance
        self.running_ids: list[int] = []
        # device-resident mirror of the scan data: the
        # back end's chain matches gather scans ON DEVICE by id instead of
        # re-uploading gather_chain's ~MB of padded host arrays per call.
        # One small append dispatch per accepted scan; poses re-upload only
        # after corrections (stale flag).
        self._dev = None                 # dict: points/masks/n_valid jnp
        self._dev_cap = 0
        self._dev_count = 0
        self._dev_poses = None
        self._dev_poses_stale = True

    def __len__(self):
        return len(self._points)

    def add(self, points: np.ndarray, mask: np.ndarray, n_valid: int,
            pose: np.ndarray, odom: np.ndarray, t: float) -> int:
        with self._lock:
            return self._add_locked(points, mask, n_valid, pose, odom, t)

    def _add_locked(self, points, mask, n_valid: int, pose, odom, t: float
                    ) -> int:
        # defensive copies: callers (process_points ingest) may reuse their
        # scan buffers between calls; the store owns its data
        points = np.array(points, np.float32, copy=True)
        mask = np.array(mask, bool, copy=True)
        self._points.append(points)
        self._masks.append(mask)
        self._n_valid.append(int(n_valid))
        w = mask.astype(np.float64)
        denom = max(w.sum(), 1.0)
        self._centroids.append((points * w[:, None]).sum(0) / denom)
        # sensor-local endpoint bbox, cached for O(scans) world-bbox
        # queries after pose corrections (4-corner transform per scan)
        pv = points[mask]
        self._local_bboxes.append(
            (pv.min(0), pv.max(0)) if len(pv)
            else (np.zeros(2, np.float32), np.zeros(2, np.float32)))
        self.poses.append(np.asarray(pose, np.float64).copy())
        self.odoms.append(np.asarray(odom, np.float64).copy())
        self.times.append(float(t))
        sid = len(self._points) - 1
        if sid >= self._bary.shape[0]:
            grown = np.zeros((2 * self._bary.shape[0], 3), np.float64)
            grown[:self._bary.shape[0]] = self._bary
            self._bary = grown
        self._update_running_range(sid)
        return sid

    def _update_running_range(self, scan_id: int):
        """Sliding window over recent scans (UpdateRunningRange,
        sensor_data_manager.h:540-558): cap the id count, then shrink from
        the front while the window's sensor-position span exceeds the
        distance bound."""
        self.running_ids.append(scan_id)
        while len(self.running_ids) > self.running_range_max_scans:
            self.running_ids.pop(0)
        def span_exceeds():
            ps = np.asarray([self.poses[i][:2] for i in self.running_ids])
            return (ps.max(0) - ps.min(0)).max() > self.running_range_max_distance
        while len(self.running_ids) > 1 and span_exceeds():
            self.running_ids.pop(0)

    def set_pose(self, scan_id: int, pose: np.ndarray):
        with self._lock:
            self.poses[scan_id] = np.asarray(pose, np.float64).copy()
            self._bary_dirty_from = min(self._bary_dirty_from, scan_id)
            self._dev_poses_stale = True
            # staleness fence for fused chain results: a prematched batch
            # computed before any pose moved (loop-closure corrections on
            # the async worker) must not be consumed afterwards — its
            # chain maps were stamped from the old poses
            self.pose_version += 1

    def poses_array(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self.poses)

    def scans_world_bbox(self):
        """Union world bbox over every stored scan's endpoints (bounded by
        the rotated local bbox corners) plus the sensor positions (carve
        rays start there). O(scans) via the cached local bboxes — used to
        grow the pub map before a correction rebuild so arbitrarily moved
        poses never stamp clipped (grid_map_base.h:257-274 grows per
        stamp; the rebuild path must grow up front)."""
        with self._lock:
            n = len(self)
            if n == 0:
                return None
            lo = np.stack([b[0] for b in self._local_bboxes])   # (n, 2)
            hi = np.stack([b[1] for b in self._local_bboxes])
            poses = np.asarray(self.poses)
        # 4 corners of each local bbox -> world; bbox(rotated bbox) bounds
        # bbox(rotated points)
        cx = np.stack([lo[:, 0], lo[:, 0], hi[:, 0], hi[:, 0]], 1)  # (n, 4)
        cy = np.stack([lo[:, 1], hi[:, 1], lo[:, 1], hi[:, 1]], 1)
        c = np.cos(poses[:, 2])[:, None]
        s = np.sin(poses[:, 2])[:, None]
        wx = poses[:, 0:1] + c * cx - s * cy
        wy = poses[:, 1:2] + s * cx + c * cy
        bmin = np.array([min(wx.min(), poses[:, 0].min()),
                         min(wy.min(), poses[:, 1].min())])
        bmax = np.array([max(wx.max(), poses[:, 0].max()),
                         max(wy.max(), poses[:, 1].max())])
        return bmin, bmax

    def _bary_of(self, ids) -> np.ndarray:
        """pose ⊕ local centroid, keeping yaw (UpdateBarycenterPose,
        sensor_data_manager.h:214-238)."""
        poses = np.asarray([self.poses[i] for i in ids])
        cent = np.asarray([self._centroids[i] for i in ids])
        c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
        bx = poses[:, 0] + c * cent[:, 0] - s * cent[:, 1]
        by = poses[:, 1] + s * cent[:, 0] + c * cent[:, 1]
        return np.stack([bx, by, poses[:, 2]], -1)

    def barycenters(self) -> np.ndarray:
        """World barycenter pose per scan, served from the incremental
        cache: appends fill rows as scans arrive; pose corrections mark a
        dirty suffix that is recomputed lazily in one vectorized pass."""
        with self._lock:
            return self._barycenters_locked()

    def _barycenters_locked(self) -> np.ndarray:
        n = len(self)
        if self._bary_dirty_from < n:
            ids = range(self._bary_dirty_from, n)
            self._bary[self._bary_dirty_from:n] = self._bary_of(ids)
            self._bary_dirty_from = n
        return self._bary[:n]

    def scan_arrays(self, scan_id: int):
        return (jnp.asarray(self._points[scan_id]),
                jnp.asarray(self._masks[scan_id]),
                jnp.int32(self._n_valid[scan_id]))

    def gather_chain(self, ids: list[int], pad_k: int):
        with self._lock:
            return self._gather_chain_locked(ids, pad_k)

    def _gather_chain_locked(self, ids: list[int], pad_k: int):
        pts = np.zeros((pad_k, self.max_points, 2), np.float32)
        msk = np.zeros((pad_k, self.max_points), bool)
        poses = np.zeros((pad_k, 3), np.float32)
        valid = np.zeros(pad_k, bool)
        for i, sid in enumerate(ids[:pad_k]):
            pts[i] = self._points[sid]
            msk[i] = self._masks[sid]
            poses[i] = self.poses[sid]
            valid[i] = True
        return (jnp.asarray(pts), jnp.asarray(msk), jnp.asarray(poses),
                jnp.asarray(valid))

    def all_arrays(self):
        """Every stored scan, padded to a power-of-two capacity bucket with
        a validity mask. Unpadded shapes made the correction map rebuilds
        recompile at every distinct scan count — each loop closure paid a
        fresh compile for its exact N (the rebuild ops all take a valid
        mask, so bucketing is free)."""
        with self._lock:
            n = len(self)
            cap = 64
            while cap < n:
                cap *= 2
            pts = np.zeros((cap, self.max_points, 2), np.float32)
            msk = np.zeros((cap, self.max_points), bool)
            poses = np.zeros((cap, 3), np.float32)
            if n:
                pts[:n] = np.stack(self._points)
                msk[:n] = np.stack(self._masks)
                poses[:n] = np.asarray(self.poses)
            valid = np.zeros(cap, bool)
            valid[:n] = True
            return (jnp.asarray(pts), jnp.asarray(msk), jnp.asarray(poses),
                    jnp.asarray(valid))

    def running_range_arrays(self, pad_k: int | None = None):
        """Padded arrays of the running-range window scans, the input shape
        the chain matchers take. The reference defines the windowed-match
        path but ships it disabled (kUseRunningRangeScanMatch = false,
        slam_processor.h:265); this accessor is the enabled equivalent."""
        ids = self.running_ids
        return self.gather_chain(ids, pad_k or self.running_range_max_scans)

    def pub_map_arrays(self):
        return self._pub_arrays

    _DEV_BUCKET_START = 256

    def device_arrays(self, reserve: int = 0):
        """``reserve``: extra slots the caller will write in-program (the
        fused step's donated append) — forces capacity growth BEFORE the
        buffers are handed out, so the in-program write never lands past
        the end (dynamic_update clamps silently)."""
        with self._lock:
            return self._device_arrays_locked(reserve)

    def absorb_fused_append(self, points, masks, n_valid, poses,
                            accepted: bool):
        """Install the store buffers returned by the fused step (the old
        ones were DONATED to it and are dead either way); advance the
        append cursor only if the scan was accepted — a rejected scan's
        slot write is simply left dead."""
        with self._lock:
            self._dev = dict(points=points, masks=masks, n_valid=n_valid)
            self._dev_poses = poses
            if accepted:
                self._dev_count += 1

    def install_buffers(self, points, masks, n_valid, poses):
        """Pipelined-fetch variant of absorb_fused_append: the append
        CURSOR lives on device (acceptance unknown until reconcile), so
        only the buffer handles rotate here; ``_dev_count`` syncs from the
        fetched cursor at reconcile time."""
        with self._lock:
            self._dev = dict(points=points, masks=masks, n_valid=n_valid)
            self._dev_poses = poses
            # _dev_poses_stale is deliberately left alone: these buffers
            # derive from the previously-installed ones, so a staleness
            # mark (a correction's set_pose) must survive the rotation
            # until the engine rebuilds the mirror (pipeline-empty
            # refresh in _process_pipelined)

    def _device_arrays_locked(self, reserve: int = 0):
        """Device-resident (cap, ...) scan buffers, appended incrementally:
        ``(points, masks, n_valid, poses_f32, cap)``. Capacity doubles in
        buckets (one full re-upload + retrace per doubling); per-scan cost
        is one small in-place append dispatch. Poses re-upload whole (tiny)
        only after ``set_pose`` invalidated them."""
        n = len(self)
        if self._dev is None or n + reserve > self._dev_cap:
            cap = self._DEV_BUCKET_START
            while cap < n + reserve:
                cap *= 2
            pts = np.zeros((cap, self.max_points, 2), np.float32)
            msk = np.zeros((cap, self.max_points), bool)
            nv = np.zeros((cap,), np.int32)
            if n:
                pts[:n] = np.stack(self._points)
                msk[:n] = np.stack(self._masks)
                nv[:n] = self._n_valid
            self._dev = dict(points=jnp.asarray(pts), masks=jnp.asarray(msk),
                             n_valid=jnp.asarray(nv))
            self._dev_cap = cap
            self._dev_count = n
            self._dev_poses_stale = True     # (re)build poses below
        if self._dev_poses_stale or self._dev_poses is None:
            p = np.zeros((self._dev_cap, 3), np.float32)
            if n:
                p[:n] = self.poses_array()
            self._dev_poses = jnp.asarray(p)
            self._dev_poses_stale = False
        while self._dev_count < n:           # appends carry their pose too
            i = self._dev_count
            d = self._dev
            append = (_store_append if self.donate_appends
                      else _store_append_nodonate)
            p, m, v, po = append(
                d["points"], d["masks"], d["n_valid"], self._dev_poses,
                jnp.asarray(self._points[i]), jnp.asarray(self._masks[i]),
                jnp.int32(self._n_valid[i]),
                jnp.asarray(self.poses[i], dtype=jnp.float32), i)
            self._dev = dict(points=p, masks=m, n_valid=v)
            self._dev_poses = po
            self._dev_count = i + 1
        d = self._dev
        return (d["points"], d["masks"], d["n_valid"], self._dev_poses,
                self._dev_cap)


@dataclasses.dataclass
class EngineDiagnostics:
    scans_in: int = 0
    scans_processed: int = 0
    scans_dropped_gate: int = 0
    scans_dropped_move: int = 0
    loop_closures: int = 0
    pub_clip_rebuilds: int = 0     # post-match growth events (_ensure_pub_covers)
    fused_steps: int = 0           # frontend dispatches that carried the
                                   # LinkNearChains chain match (1 dispatch)
    match_time_s: float = 0.0
    backend_time_s: float = 0.0


class SlamEngine:
    """Online SLAM over a scan stream."""

    def __init__(self, config: SlamConfig, laser: LaserModel,
                 world_size: float | None = None,
                 synchronous_backend: bool = True,
                 fused_backend: bool = True):
        self.config = config
        self.laser = laser
        # requested world extent (pre-rounding) — checkpoints restore with
        # this exact value so map spec shapes reproduce
        self.world_size = (world_size if world_size is not None
                           else config.derived_world_size(laser.range_max))
        self.fspec = FrontendSpec.from_config(config, laser.range_max,
                                              self.world_size)
        self.bspec = BackendSpec.from_config(config, laser.range_max,
                                             self.fspec.pub_spec)
        self.state: FrontendState = init_frontend_state(self.fspec)
        # host mirror of the tiny, rarely-changing bits of device state
        # (current pose + map offsets). Every np.asarray(device_array) is
        # its own device round-trip; the per-scan geometry checks read
        # these instead. Updated at the
        # single post-step fetch, on growth/recenter, on corrections, and
        # on checkpoint restore.
        self._host_pose = np.zeros(3)
        offs = jax.device_get((self.state.fine.offset,
                               self.state.coarse.offset,
                               self.state.pub.offset))
        self._host_fine_off = np.asarray(offs[0], np.float64)
        self._host_coarse_off = np.asarray(offs[1], np.float64)
        self._host_pub_off = np.asarray(offs[2], np.float64)
        self.store = ScanStore(
            config.max_points,
            running_range_max_scans=config.running_range_size,
            running_range_max_distance=config.running_range_max_distance)
        self.store.donate_appends = synchronous_backend
        self.backend = Backend(self.bspec, self.store)
        self.backend.on_corrections = self._apply_corrections
        self.synchronous_backend = synchronous_backend
        # fuse the LinkNearChains chain match into the frontend dispatch.
        # Async mode uses the non-donating variant (the worker thread can
        # concurrently dispatch reads of the store buffers) and carries the
        # prematched results through the queue — round 4 enqueued None and
        # redid the chain work, pushing async to 1.19-1.33 disp/scan.
        self._fused_backend = fused_backend
        self.diag = EngineDiagnostics()
        self.timers = StageTimers()
        self._bounds_warned = False
        self.trajectory: list[tuple[float, np.ndarray]] = []  # (t, pose) per processed scan
        self._last_kept_odom: np.ndarray | None = None
        self._move_ref_odom: np.ndarray | None = None
        self._last_process_time: float | None = None
        self._odom_history: list[tuple[float, np.ndarray]] = []
        # buffer donation reuses map arrays in place, but is only safe when
        # the back end cannot hold references across a later step
        donate = (1,) if synchronous_backend else ()
        self._step = jax.jit(
            _step_summary, static_argnames=("spec",), donate_argnums=donate)
        if config.use_running_range_scan_match:
            self._step_windowed = jax.jit(
                _step_windowed_summary, static_argnames=("spec",),
                donate_argnums=donate)
        self._pending_backend: list[tuple] = []   # (scan_id, cov, prematched)
        # map→odom transform (the reference's 100 Hz TF broadcast state,
        # roborts_slam_node.cpp:178-196): pose_at(t) composes it with
        # odometry interpolated at t, so consumers get a pose BETWEEN kept
        # scans. Updated per accepted scan and on corrections.
        self._map_to_odom = np.zeros(3)       # (tx, ty, dtheta)
        # live-output hooks (PublishMapThread / PublishVisualization
        # analogs, roborts_slam_node.cpp:355-488): on_pose fires per
        # accepted scan; on_map_snapshot every map_snapshot_every kept
        # scans with the rendered occupancy grid
        self.on_pose: "Callable[[float, np.ndarray], None] | None" = None
        self.on_map_snapshot: "Callable[[int, np.ndarray], None] | None" = None
        self.map_snapshot_every: int = 0      # 0 = disabled
        # double-buffered fetch pipeline: dispatch scan k+1..k+depth while
        # scan k's summary fetch is in flight, so the fetch latency
        # overlaps the next dispatches. Host
        # bookkeeping (store append, graph update, gating mirrors)
        # reconciles ``pipeline_depth`` scans behind; map-mutating events
        # (growth, recenter, corrections, loop closures) drain first.
        # Sync backend + non-windowed paths only; opt-in.
        self.pipelined_fetch = False
        self.pipeline_depth = 3
        self._inflight: list[dict] = []
        self._dev_cursor = None               # device (1,) i32 append cursor
        self._pipe_bucket: int | None = None  # fixed fused chain bucket
        self._pipe_empty = None               # cached all-(-1) id matrix
        self._pipe_seeded = False             # device move-gate time seeded
        self._prev_process_time: float | None = None
        self._last_kept_time: float | None = None
        # async pipeline (BackEndProcessThread, slam_processor.cpp:384-426):
        # the front end streams scans while the worker drains the queue
        self._state_lock = threading.Lock()
        self._backend_queue = (_queue.SimpleQueue()
                               if not synchronous_backend else None)
        # worker spawns lazily on the first enqueued scan
        # (_ensure_backend_thread), and revives after finish()
        self._backend_thread: threading.Thread | None = None

    # ---- gates (MoveEnough, slam_processor.cpp:604-616) ----

    def _publish_pub_arrays(self):
        """Install the feedback pub-map snapshot the back-end reads
        (ScanStore.pub_map_arrays). Sync mode hands out the live state
        arrays (single reader, refreshed before every consumer). Async
        mode hands out COPIES: the frontend's next dispatch DONATES the
        state pytree, so a worker holding the live hits/passes between its
        snapshot and its chain-match dispatch would hit
        "Array has been deleted" (use-after-donate race)."""
        pub = self.state.pub
        if self.synchronous_backend:
            arrs = (pub.hits, pub.passes, pub.offset)
        else:
            arrs = _copy3(pub.hits, pub.passes, pub.offset)
        self.store._pub_arrays = (self.fspec.pub_spec, *arrs)

    def _move_enough(self, odom: np.ndarray, t: float) -> bool:
        cfg = self.config
        if not cfg.use_odometry or not cfg.use_move_check:
            return True
        # pipelined mode: gate against the newest DISPATCHED scan's odom
        # (optimistic — in-flight scans are assumed kept; comparing to the
        # reconciled-but-stale last-kept odom would stop rejecting
        # anything). _last_kept_odom itself stays paired with _host_pose
        # for odometry prediction.
        ref = (self._move_ref_odom if self._move_ref_odom is not None
               else self._last_kept_odom)
        if ref is None:
            return True
        if (self._last_process_time is not None
                and t - self._last_process_time > cfg.move_time_threshold):
            return True
        d = odom[:2] - ref[:2]
        if np.hypot(d[0], d[1]) >= cfg.move_distance_threshold:
            return True
        dth = np.arctan2(np.sin(odom[2] - ref[2]), np.cos(odom[2] - ref[2]))
        return abs(dth) >= cfg.move_angle_threshold

    # ---- main entry ----

    def process(self, ranges: np.ndarray, odom: np.ndarray, t: float) -> bool:
        """Feed one scan (raw ranges); returns True if accepted."""
        self._odom_history.append((t, np.asarray(odom, np.float64).copy()))
        if len(self._odom_history) > 64:
            self._odom_history.pop(0)
        # move gate BEFORE any conversion work — rejected scans must cost
        # nothing on the ingest path (MoveEnough runs first in the
        # reference too, slam_processor.cpp:92)
        if not self._pass_move_gate(odom, t):
            return False
        if (self.config.use_odom_correct and self.laser.scan_time > 0
                and len(self._odom_history) >= 2):
            points, mask, n_valid = self._dedistorted_points(ranges, t)
        else:
            # pure-NumPy ingest: building jnp arrays here and fetching them
            # back for the host-side store would cost 3 round-trips/scan
            points, mask, n_valid = ranges_to_packed(
                ranges, self.laser, self.config.max_points)
        return self._process_gated(points, mask, n_valid, odom, t)

    def _dedistorted_points(self, ranges: np.ndarray, t: float):
        """Odometry-based sweep de-distortion (LaserDataProcessor,
        laser_data_processor.cpp:43-314) on the ingest path: re-project each
        beam into the sweep-END frame (scans are stamped, and odometry
        paired, at time ``t`` = end of sweep), then gate and front-pack like
        scan_from_ranges."""
        from .io.dedistort import dedistort_scan

        ranges = np.asarray(ranges, np.float32)
        # the reference also drops beams beyond range_threshold
        # (roborts_slam_node.cpp:295-307); mark them invalid pre-correction
        gated = np.where(ranges < self.laser.range_threshold, ranges, 0.0)
        ot = np.array([h[0] for h in self._odom_history])
        op = np.stack([h[1] for h in self._odom_history])
        pts = dedistort_scan(gated, self.laser, t - self.laser.scan_time,
                             self.laser.scan_time, ot, op, reference="end")
        from .models.scan import pack_points

        return pack_points(pts[~np.isnan(pts[:, 0])], self.config.max_points)

    def process_points(self, points, mask, n_valid: int, odom: np.ndarray,
                       t: float) -> bool:
        """Feed one pre-converted scan (sensor-local cartesian points,
        front-packed mask) — the native RSLG stream's ingest path."""
        if not self._pass_move_gate(odom, t):
            return False
        return self._process_gated(points, mask, n_valid, odom, t)

    def _pass_move_gate(self, odom: np.ndarray, t: float) -> bool:
        self.diag.scans_in += 1
        if (self.pipelined_fetch and self.synchronous_backend
                and not self.config.use_running_range_scan_match
                and len(self.store) > 0):
            # pipelined mode: the host pre-filter is OPTIMISTIC (gates
            # against the newest dispatched scan's odometry, assuming
            # in-flight scans will be kept — true whenever the score gate
            # passes, which is the overwhelming case) and the IN-PROGRAM
            # MoveEnough gate is the exactness backstop: any scan the
            # optimism lets through but the true gate rejects is dropped
            # on device with the exact last-kept reference. A
            # provably-safe host filter was tried and cannot prune under
            # continuous motion (the true reference is genuinely
            # ambiguous until reconcile), collapsing icra to 27 kept/s —
            # dispatching every scan costs a fetch each. Residual
            # divergence vs blocking: optimistic false-DROPS in the rare
            # windows right after a score-gate rejection
            # (docs/PERFORMANCE.md, willow full-scene table).
            if not self._move_enough(odom, t):
                self.diag.scans_dropped_move += 1
                return False
            return True
        if self._move_enough(odom, t):
            return True
        self.diag.scans_dropped_move += 1
        return False

    def _process_gated(self, points, mask, n_valid: int, odom: np.ndarray,
                       t: float) -> bool:
        """Run the front-end step on an already-gated, already-converted
        scan (both ingest paths funnel here)."""
        self._prev_process_time = self._last_process_time
        self._last_process_time = t

        np_points = np.asarray(points)
        np_mask = np.asarray(mask)
        if (self.pipelined_fetch and self.synchronous_backend
                and not self.config.use_running_range_scan_match
                and len(self.store) > 0):
            return self._process_pipelined(np_points, np_mask, n_valid,
                                           np.asarray(odom, np.float64), t)
        # grow the pub map BEFORE the stamp dispatch so this scan lands
        # unclipped (UpdateBound runs inside UpdateMapByRange in the
        # reference, grid_map_base.h:257-274); the predicted pose is within
        # the search window (< the 0.5 m bbox pad) of the matched pose
        self._maybe_grow_pub(self._predict_pose_host(np.asarray(odom)),
                             np_points, np_mask)
        fused_in = None
        if (self._fused_backend
                and not self.config.use_running_range_scan_match
                and len(self.store) > 0):
            fused_in = self._prepare_fused(np_points, np_mask,
                                           np.asarray(odom))
        points, mask = jnp.asarray(points), jnp.asarray(mask)

        chain_out = None
        t0 = _time.perf_counter()
        with self._state_lock, self.timers.stage("frontend_step"):
            if (self.config.use_running_range_scan_match
                    and len(self.store) > 0):
                # windowed match path (slam_processor.cpp:134-159): the
                # running-range window scans are the match map source,
                # gathered on device from the store mirror by id
                all_pts, all_msk, _all_nv, all_poses, _cap = \
                    self.store.device_arrays()
                W = self.config.running_range_size
                win_ids = np.full((W,), -1, np.int32)
                rids = self.store.running_ids[-W:]
                win_ids[:len(rids)] = rids
                self.state, summary = self._step_windowed(
                    self.fspec, self.state, all_pts, all_msk, all_poses,
                    jnp.asarray(win_ids), points, mask,
                    jnp.int32(n_valid), jnp.asarray(odom, jnp.float32))
            elif fused_in is not None:
                from .backend.processor import (
                    fused_frontend_chain_step,
                    fused_frontend_chain_step_nodonate,
                )

                fused_fn = (fused_frontend_chain_step
                            if self.synchronous_backend
                            else fused_frontend_chain_step_nodonate)
                all_pts, all_msk, all_nv, all_poses, _cap = \
                    self.store.device_arrays(reserve=1)
                slot = self.store._dev_count
                self.state, summary, new_store = fused_fn(
                    self.fspec, self.bspec, self.state, points, mask,
                    jnp.int32(n_valid), jnp.asarray(odom, jnp.float32),
                    all_pts, all_msk, all_nv, all_poses,
                    fused_in["ids"], jnp.int32(slot))
                chain_out = True    # chain rows ride the packed summary
                self.diag.fused_steps += 1
            else:
                self.state, summary = self._step(
                    self.fspec, self.state, points, mask,
                    jnp.int32(n_valid), jnp.asarray(odom, jnp.float32))
        # ONE fetch of the packed summary — pose + cov + gates, PLUS the
        # (B, 13) fused chain rows when this was a fused step. Each
        # additional fetched leaf would be its own device round-trip.
        # Timed apart from the enqueue: this wait IS the step's
        # completion.
        with self.timers.stage("frontend_fetch"):
            s = np.asarray(jax.device_get(summary), np.float64)
        accepted = bool(s[12] > 0.5)
        if chain_out is not None:
            # the fused dispatch consumed (sync: donated) the store
            # buffers; install the returned ones whether or not the scan
            # was kept
            self.store.absorb_fused_append(*new_store, accepted=accepted)
        pose = s[:3].copy()
        cov_f = s[3:12].reshape(3, 3)
        # summary's pose IS the new state.pose (frontend_step stores the
        # same gated value in both), so the mirror updates unconditionally
        self._host_pose = pose.copy()
        # refresh the back-end's pub snapshot for REJECTED scans too: the
        # dispatch above donated the previous state whose arrays the old
        # snapshot referenced (a later force_graph_optimize / async worker
        # read would hit deleted buffers)
        self._publish_pub_arrays()
        self.diag.match_time_s += _time.perf_counter() - t0

        if not accepted:
            self.diag.scans_dropped_gate += 1
            return False

        self.diag.scans_processed += 1
        if self.config.match_map_window > 0:
            self._maybe_recenter(pose)
        else:
            self._check_world_bounds(pose)
        self._last_kept_odom = np.asarray(odom, np.float64).copy()
        self._move_ref_odom = self._last_kept_odom
        self._last_kept_time = float(t)
        scan_id = self.store.add(np_points, np_mask, n_valid, pose, odom, t)
        self.trajectory.append((t, pose))
        self._update_map_to_odom(pose, np.asarray(odom, np.float64))
        if self.on_pose is not None:
            self.on_pose(t, pose.copy())
        if (self.map_snapshot_every > 0 and self.on_map_snapshot is not None
                and len(self.store) % self.map_snapshot_every == 0):
            self.on_map_snapshot(len(self.store), self.get_pub_map())
        self._ensure_pub_covers(pose, np_points, np_mask)

        cov = np.asarray(cov_f, np.float64)
        prematched = None
        if chain_out is not None:
            # the chain rows arrived IN the summary fetch: (B, 13) rows of
            # pose(3) + score(1) + cov(9) after the 15-float step summary
            flat = s[15:].reshape(-1, 13)
            rows = [(flat[i, :3].copy(), float(flat[i, 3]),
                     flat[i, 4:13].reshape(3, 3).copy())
                    for i in range(len(fused_in["near"])
                                   + len(fused_in["loop"]))]
            nn = len(fused_in["near"])
            prematched = {
                "near": ((fused_in["near"], rows[:nn])
                         if fused_in["near"] else None),
                "loop": ((fused_in["loop"], rows[nn:])
                         if fused_in["loop"] else None),
                "pose_version": fused_in["pose_version"],
            }
        if self.synchronous_backend:
            self._pending_backend.append((scan_id, cov, prematched))
            self.process_backend()
        else:
            self._ensure_backend_thread()
            self._backend_queue.put((scan_id, cov, prematched))
        return True

    # ---- double-buffered fetch pipeline ----

    @staticmethod
    def _bary_of_pose(pose: np.ndarray, np_points: np.ndarray,
                      np_mask: np.ndarray) -> np.ndarray:
        w = np_mask.astype(np.float64)
        denom = max(w.sum(), 1.0)
        cent = (np_points.astype(np.float64) * w[:, None]).sum(0) / denom
        c, s = np.cos(pose[2]), np.sin(pose[2])
        return np.array([pose[0] + c * cent[0] - s * cent[1],
                         pose[1] + s * cent[0] + c * cent[1], pose[2]])

    def _pub_growth_needed(self, bmin: np.ndarray, bmax: np.ndarray) -> bool:
        spec = self.fspec.pub_spec
        off = self._host_pub_off
        extent = np.array([spec.width, spec.height]) * spec.resolution
        return bool((np.asarray(bmin) + off < 0).any()
                    or (np.asarray(bmax) + off > extent).any())

    def _select_pipe_bucket(self) -> int:
        """The pipeline's ONE fixed fused-chain bucket. Shared by dispatch
        and warm_backend so warm-up compiles exactly the executable the
        pipeline runs (a divergence here reintroduces the per-scan
        executable-switch worst case)."""
        if self._pipe_bucket is None:
            lim = self.backend.max_parallel_chains(fused=True)
            self._pipe_bucket = max(
                (b for b in self.backend._BATCH_BUCKETS
                 if b <= min(lim, 4)), default=1)
        return self._pipe_bucket

    def _pipe_empty_ids(self):
        K = self.bspec.max_chain_scans
        if (self._pipe_empty is None
                or self._pipe_empty.shape != (self._pipe_bucket, K)):
            self._pipe_empty = jnp.asarray(
                np.full((self._pipe_bucket, K), -1, np.int32))
        return self._pipe_empty

    def _drain_pipeline(self):
        """Reconcile every in-flight scan (map-mutating events and
        output/readback surfaces call this first). Reentrant: each
        reconcile pops its entry before processing, so nested drains from
        inside a reconcile terminate."""
        while self._inflight:
            self._reconcile_one()

    def _process_pipelined(self, np_points: np.ndarray, np_mask: np.ndarray,
                           n_valid: int, odom: np.ndarray, t: float) -> bool:
        """Dispatch this scan WITHOUT waiting for its summary: the fetch
        rides behind the next ``pipeline_depth`` dispatches (they overlap
        on the device), and host bookkeeping reconciles that many scans
        behind. The step's odometry prediction and the store-append cursor
        live on device, so chained dispatches need nothing from the
        pending fetches; growth/capacity events drain the pipeline first.
        Returns True optimistically (acceptance is known at reconcile; the
        kept-scan accounting is exact, only this return value is early).
        """
        from .backend.processor import fused_cursor_step

        t0 = _time.perf_counter()
        pred = self._predict_pose_host(odom)
        # pub growth must precede the stamp; the pad absorbs match-vs-
        # predict translation plus the extra odometry lag of the pipeline
        bmin, bmax = self._scan_world_bbox(pred, np_points, np_mask)
        pad = self._search_pad() + 0.25
        if self._pub_growth_needed(bmin - pad, bmax + pad):
            self._drain_pipeline()
            self._grow_pub_to_bbox(bmin - pad, bmax + pad)
        # device-store capacity: buffers must never re-upload mid-pipeline
        # (the host rebuild would drop in-flight appends)
        need = len(self.store) + len(self._inflight) + 2
        if self.store._dev is None or need > self.store._dev_cap:
            self._drain_pipeline()
            self.store.device_arrays(reserve=self.pipeline_depth + 2)
        # ONE executable for every pipelined scan: the fused cursor program
        # runs with a
        # FIXED chain bucket, skipping the chain branch in-program when no
        # chains are predicted.
        self._select_pipe_bucket()
        fused_in = None
        if self._fused_backend:
            fused_in = self._prepare_fused(np_points, np_mask, odom,
                                           pending=self._inflight,
                                           bucket=self._pipe_bucket)
        if not self._pipe_seeded:
            # the device MoveEnough gate needs the host's last-process
            # time (blocking-path dispatches never carried cur_time, so
            # state.last_step_time is still -inf and the first pipelined
            # scan would always pass the time check)
            lt = (self._prev_process_time
                  if self._prev_process_time is not None else -3.4e38)
            self.state = self.state._replace(
                last_step_time=jnp.float32(lt))
            self._pipe_seeded = True
        if not self._inflight:
            # (re)seed the device cursor whenever the pipeline is empty —
            # self-heals across drains, growth, corrections
            self._dev_cursor = jnp.asarray(
                np.array([len(self.store)], np.int32))
            if self.store._dev_poses_stale:
                # a correction (loop closure / force_graph_optimize)
                # rewrote stored poses; rebuild the device pose mirror
                # before the next chain gather reads it. Corrections only
                # land with the pipeline drained (closures drain first;
                # the public surfaces drain too), so host poses are
                # authoritative here.
                self.store.device_arrays()
        d = self.store._dev
        bufs = (d["points"], d["masks"], d["n_valid"],
                self.store._dev_poses)
        points, mask = jnp.asarray(np_points), jnp.asarray(np_mask)
        if fused_in is not None:
            ids = fused_in["ids"]
            self.diag.fused_steps += 1
        else:
            ids = self._pipe_empty_ids()
        with self._state_lock, self.timers.stage("pipe_dispatch"):
            (self.state, packed, new_store,
             self._dev_cursor) = fused_cursor_step(
                self.fspec, self.bspec, self.state, points, mask,
                jnp.int32(n_valid), jnp.asarray(odom, jnp.float32),
                jnp.float32(t), *bufs, ids, self._dev_cursor)
        self.store.install_buffers(*new_store)
        with self.timers.stage("pipe_copy_async"):
            try:
                packed.copy_to_host_async()
            except Exception:  # noqa: BLE001 — overlap is best-effort
                pass
        self._move_ref_odom = np.asarray(odom, np.float64).copy()
        self._inflight.append(dict(
            packed=packed, fused_in=fused_in,
            np_points=np_points.copy(), np_mask=np_mask.copy(),
            n_valid=int(n_valid), odom=np.asarray(odom, np.float64).copy(),
            t=float(t), bary=self._bary_of_pose(pred, np_points, np_mask)))
        self.diag.match_time_s += _time.perf_counter() - t0
        while len(self._inflight) > self.pipeline_depth:
            self._reconcile_one()
        return True

    def _reconcile_one(self) -> bool:
        """Complete the OLDEST in-flight scan: fetch its packed summary
        (usually already arrived), commit store/trajectory/mirrors, run
        the back-end graph update, and attempt loop closure (draining the
        rest of the pipeline first when candidates exist, since a closure
        rewrites every map)."""
        e = self._inflight.pop(0)
        with self.timers.stage("frontend_fetch"):
            s = np.asarray(e["packed"]).astype(np.float64)
        accepted = bool(s[12] > 0.5)
        pose = s[:3].copy()
        self._host_pose = pose.copy()
        if not accepted:
            # match the blocking path's drop attribution: a scan whose
            # SCORE cleared the accept threshold (s[14]) was blocked by
            # the in-program MoveEnough backstop — blocking mode counts
            # those on the host move gate. (A map-update move-check fail
            # with a passing score is misattributed here — blocking calls
            # it a gate drop — an accepted diagnostics approximation.)
            if s[14] > max(0.5, self.config.map_update_score_threshold):
                self.diag.scans_dropped_move += 1
            else:
                self.diag.scans_dropped_gate += 1
            # (rewinding _move_ref_odom to the last kept odom here was
            # tried and measured: more dispatches, slightly FEWER kept
            # scans and the same ATE on the full willow replay — the
            # optimistic reference stays, docs/PERFORMANCE.md table)
            return False
        t0 = _time.perf_counter()
        self.diag.scans_processed += 1
        # ---- commit phase — NO nested drains allowed: the device wrote
        # this scan at its cursor slot BEFORE any younger in-flight scan,
        # so the host must commit in the same order (a drain here would
        # let a younger scan take this scan's store id / graph vertex and
        # permanently skew every id-addressed device gather) ----
        self._last_kept_odom = e["odom"].copy()
        self._last_kept_time = float(e["t"])
        scan_id = self.store.add(e["np_points"], e["np_mask"], e["n_valid"],
                                 pose, e["odom"], e["t"])
        # the device append cursor advanced in-program; mirror it
        self.store._dev_count = int(round(s[15]))
        n_committed = len(self.store)
        self.trajectory.append((e["t"], pose))
        self._update_map_to_odom(pose, e["odom"])
        if self.on_pose is not None:
            self.on_pose(e["t"], pose.copy())
        self._publish_pub_arrays()
        # the graph vertex belongs to the commit too: a nested drain may
        # run a younger scan's update_graph, and vertex ids must follow
        # store-commit order (add_vertex asserts vid == scan_id)
        cov = s[3:12].reshape(3, 3)
        prematched = None
        fused_in = e["fused_in"]
        if fused_in is not None:
            flat = s[16:].reshape(-1, 13)
            rows = [(flat[i, :3].copy(), float(flat[i, 3]),
                     flat[i, 4:13].reshape(3, 3).copy())
                    for i in range(len(fused_in["near"])
                                   + len(fused_in["loop"]))]
            nn = len(fused_in["near"])
            prematched = {
                "near": ((fused_in["near"], rows[:nn])
                         if fused_in["near"] else None),
                "loop": ((fused_in["loop"], rows[nn:])
                         if fused_in["loop"] else None),
                "pose_version": fused_in["pose_version"],
            }
        pre = self._fresh_prematched(prematched)
        with self.timers.stage("backend_update"):
            self.backend.update_graph(scan_id, cov,
                                      prematched=(pre or {}).get("near"))
        # ---- event phase — this scan is fully committed (store + graph),
        # so draining the remaining in-flight scans preserves commit
        # order. Chain matches rebuild their own pair maps, so running
        # update_graph before a recenter/clip event matches blocking
        # semantics ----
        if self.config.match_map_window > 0:
            fs = self.fspec.fine_spec
            extent = np.array([fs.width, fs.height]) * fs.resolution
            center_w = extent * 0.5 - self._host_fine_off
            window = min(float(extent[0]), float(extent[1]))
            if np.max(np.abs(pose[:2] - center_w)) > 0.25 * window:
                self._drain_pipeline()     # recenter rebuilds the maps
            self._maybe_recenter(pose)
        else:
            self._check_world_bounds(pose)
        if (self.map_snapshot_every > 0 and self.on_map_snapshot is not None
                and n_committed % self.map_snapshot_every == 0):
            self._drain_pipeline()        # the rendered map must be current
            self.on_map_snapshot(len(self.store), self.get_pub_map())
        # post-match clip safety net (rare): the rebuild needs the full
        # store, so complete the pipeline before growing
        bmin, bmax = self._scan_world_bbox(pose, e["np_points"], e["np_mask"])
        if self._pub_growth_needed(bmin, bmax):
            self._drain_pipeline()
            self._grow_pub_to_bbox(bmin, bmax)
            self.diag.pub_clip_rebuilds += 1
            with self._state_lock:
                self._rebuild_pub_locked()
        # loop closure corrects every pose + rebuilds every map: only
        # attempt when candidates actually exist, and finish the pipeline
        # first. Candidates are a cheap vectorized barycenter query.
        bary = self.store.barycenters()
        if self.backend.graph.find_all_loop_candidates(scan_id, bary):
            self._drain_pipeline()
            pre = self._fresh_prematched(prematched)
            with self.timers.stage("backend_loop_closure"):
                self.backend.try_close_loop(
                    scan_id, prematched=(pre or {}).get("loop"))
        self.diag.loop_closures = self.backend.num_loop_closures
        self.diag.backend_time_s += _time.perf_counter() - t0
        return True

    def _prepare_fused(self, np_points: np.ndarray, np_mask: np.ndarray,
                       odom: np.ndarray, pending: list | None = None,
                       bucket: int | None = None):
        """Pre-discover the chain sets this scan's back-end pass will match
        — LinkNearChains' near chains AND TryCloseLoop's first-round loop
        candidates (both use the matched pose as init/center, so their
        coarse matches are the SAME program) — from the odom-predicted pose
        + this scan's centroid, so every one of them rides the frontend
        dispatch (fused_frontend_chain_step). Returns
        ``{"near": chains, "loop": chains, "ids": (B, K) id matrix}`` or
        None when fusion does not apply (no eligible chains, or more than
        one dispatch may hold)."""
        cfg = self.config
        pred = self._predict_pose_host(odom)
        newbary = self._bary_of_pose(pred, np_points, np_mask)
        # pipelined mode: in-flight scans enter discovery as hypothetical
        # vertices at their predicted barycenters (assumed kept; the
        # consume-time set-equality check falls back on any divergence)
        pend = [e["bary"] for e in (pending or [])]
        rows = ([self.store.barycenters()]
                + ([np.asarray(pend)] if pend else []) + [newbary[None]])
        bary = np.concatenate(rows)
        k = len(pend) + 1
        graph = self.backend.graph
        near = [ch for ch in graph.find_near_chains_for_new(bary, k=k)
                if len(ch) >= cfg.loop_match_min_chain_size]
        loop = graph.find_all_loop_candidates_for_new(bary, k=k)
        lim = self.backend.max_parallel_chains(fused=True)
        step = max((b for b in self.backend._BATCH_BUCKETS if b <= lim),
                   default=1)
        if bucket is not None:
            step = min(step, bucket)
        if len(near) + len(loop) > step:
            loop = []         # loop rows are opportunistic; drop them first
        if len(near) > step or not (near or loop):
            return None       # would need chunking: keep the separate path
        from .backend.pose_graph import PoseGraph

        K = self.bspec.max_chain_scans
        rows = [PoseGraph.sparsify_chain(ch) for ch in near] + loop
        bucket = (bucket if bucket is not None
                  else next(b for b in self.backend._BATCH_BUCKETS
                            if b >= len(rows)))
        ids = np.full((bucket, K), -1, np.int32)
        for b, chain in enumerate(rows):
            ids[b, :min(len(chain), K)] = chain[:K]
        return {"near": near, "loop": loop, "ids": jnp.asarray(ids),
                "pose_version": self.store.pose_version}

    def process_backend(self):
        """Drain the back-end buffer (BackEndProcessThread,
        slam_processor.cpp:384-426): graph updates for every pending scan,
        then one loop-closure attempt at the newest."""
        if not self._pending_backend:
            return
        t0 = _time.perf_counter()
        last_id = self._pending_backend[-1][0]
        last_pre = None
        with self.timers.stage("backend_update"):
            while self._pending_backend:
                sid, cov, pre = self._pending_backend.pop(0)
                pre = self._fresh_prematched(pre)
                self.backend.update_graph(
                    sid, cov, prematched=(pre or {}).get("near"))
                if sid == last_id:
                    last_pre = pre
        with self.timers.stage("backend_loop_closure"):
            self.backend.try_close_loop(
                last_id,
                prematched=(self._fresh_prematched(last_pre) or {})
                .get("loop"))
        self.diag.loop_closures = self.backend.num_loop_closures
        self.diag.backend_time_s += _time.perf_counter() - t0

    def _fresh_prematched(self, pre):
        """Drop a fused prematched batch whose chain maps were stamped
        from since-corrected poses (store.pose_version moved): the
        consumer then redoes the chain match against fresh maps, exactly
        the separate-dispatch path. A drop counts as a fused miss."""
        if pre is None:
            return None
        if pre.get("pose_version") != self.store.pose_version:
            self.backend.num_fused_misses += 1
            return None
        return pre

    def _check_world_bounds(self, pose: np.ndarray):
        """Without a rolling match window (match_map_window == 0) the fine
        and coarse *match* maps keep the preallocated world extent (static
        shapes); warn loudly (once) when the trajectory nears their edge —
        the fix is a larger ``world_size`` or ``match_map_window``. The pub
        map itself grows on demand (_maybe_grow_pub)."""
        if self._bounds_warned:
            return
        off = self._host_fine_off
        res = self.fspec.fine_spec.resolution
        extent = np.array([self.fspec.fine_spec.width,
                           self.fspec.fine_spec.height]) * res
        cell = pose[:2] + off
        margin = self.laser.range_max * 0.5
        if (cell < margin).any() or (cell > extent - margin).any():
            import warnings

            warnings.warn(
                f"pose {pose[:2]} within {margin:.1f} m of the preallocated "
                f"match-map edge (extent {extent}); matching will degrade — "
                f"increase world_size or set match_map_window",
                RuntimeWarning, stacklevel=3)
            self._bounds_warned = True

    # ---- pub map growth (GridMapBase::UpdateBound/ExtendSize,
    #      grid_map_base.h:188-274) ----

    _PUB_GROW_ALIGN = 256    # growth granularity (cells) bounds retraces

    def _predict_pose_host(self, odom: np.ndarray) -> np.ndarray:
        """Host-side copy of predict_pose_by_odom (slam_processor.cpp:618-634)
        for pre-dispatch geometry checks — reads the host pose mirror
        (fetching state.pose here would cost one round-trip per scan)."""
        pose = self._host_pose.copy()
        if not self.config.use_odometry or self._last_kept_odom is None:
            return pose
        lo = self._last_kept_odom
        dth = pose[2] - lo[2]
        c, s = np.cos(dth), np.sin(dth)
        tx = pose[0] - (c * lo[0] - s * lo[1])
        ty = pose[1] - (s * lo[0] + c * lo[1])
        return np.array([c * odom[0] - s * odom[1] + tx,
                         s * odom[0] + c * odom[1] + ty,
                         dth + odom[2]])

    def _search_pad(self) -> float:
        """Slack (m) the pre-dispatch pub growth adds around the PREDICTED
        scan bbox: the matched pose can translate from the prediction by at
        most the stacked correlative search half-windows (coarse — or the
        BnB window replacing it — then fine, then super-fine refinements,
        scan_matchers.h:307-355), plus cell-rounding slack. Rotational
        search can move endpoints further; that tail is caught exactly by
        the post-match clip check (_ensure_pub_covers), so it does not
        inflate every growth."""
        cfg = self.config
        coarse = cfg.coarse_search_space_size
        if cfg.use_fast_correlation_match:
            coarse = max(coarse, cfg.fast_match_space_size)
        return (0.5 * (coarse + cfg.fine_search_space_size
                       + cfg.super_fine_search_space_size)
                + 2.0 * self.fspec.pub_spec.resolution)

    def _grow_pub_to_bbox(self, bmin: np.ndarray, bmax: np.ndarray,
                          _locked: bool = False) -> bool:
        """Grow the pub map (never shrinks) so [bmin, bmax] (world meters)
        is inside its extent; returns True if it grew. Callers must NOT
        hold the state lock unless they pass ``_locked=True``.

        The need/grow computation reads the live spec + offset mirrors, and
        the async back-end worker can also grow the map (through
        _apply_corrections_locked) — so the read AND the resize must share
        one lock acquisition, or a growth racing in between makes the
        precomputed new_w/new_h smaller than the live map and the
        `hits[shift:shift+H] = old` copy in _grow_pub_to misplaces/raises."""
        if _locked:
            return self._grow_pub_to_bbox_locked(bmin, bmax)
        with self._state_lock:
            return self._grow_pub_to_bbox_locked(bmin, bmax)

    def _grow_pub_to_bbox_locked(self, bmin: np.ndarray,
                                 bmax: np.ndarray) -> bool:
        spec = self.fspec.pub_spec
        res = spec.resolution
        off = self._host_pub_off
        extent = np.array([spec.width, spec.height]) * res      # (x, y) m
        need_lo = np.maximum(0.0, -(np.asarray(bmin) + off))    # m past low edge
        need_hi = np.maximum(0.0, (np.asarray(bmax) + off) - extent)
        if (need_lo <= 0).all() and (need_hi <= 0).all():
            return False
        align = self._PUB_GROW_ALIGN
        cells = lambda m: (-(-np.ceil(m / res).astype(np.int64) // align)
                           * align)
        grow_lo = np.where(need_lo > 0, cells(need_lo), 0)      # (x, y) cells
        grow_hi = np.where(need_hi > 0, cells(need_hi), 0)
        self._grow_pub_to(spec.width + int(grow_lo[0] + grow_hi[0]),
                          spec.height + int(grow_lo[1] + grow_hi[1]),
                          int(grow_lo[0]), int(grow_lo[1]))
        return True

    def _scan_world_bbox(self, pose: np.ndarray, points: np.ndarray,
                         mask: np.ndarray):
        pts = points[mask]
        c, s = np.cos(pose[2]), np.sin(pose[2])
        if len(pts):
            wx = pose[0] + c * pts[:, 0] - s * pts[:, 1]
            wy = pose[1] + s * pts[:, 0] + c * pts[:, 1]
        else:
            wx = wy = np.zeros(0)
        bmin = np.array([min(wx.min(initial=pose[0]), pose[0]),
                         min(wy.min(initial=pose[1]), pose[1])])
        bmax = np.array([max(wx.max(initial=pose[0]), pose[0]),
                         max(wy.max(initial=pose[1]), pose[1])])
        return bmin, bmax

    def _maybe_grow_pub(self, pose: np.ndarray, points: np.ndarray,
                        mask: np.ndarray):
        """Grow the published map so this scan's world bound box fits — the
        The equivalent of the reference's dynamic map resize
        (``UpdateBound`` grows the allocation to the scan bbox and copies old
        cells in, grid_map_base.h:188-274). Runs BEFORE the stamp dispatch
        (the reference grows inside UpdateMapByRange for the same reason);
        host-side re-allocation in 256-cell buckets keeps shapes static per
        bucket — one jit retrace per growth event. The pad covers the
        match-vs-predict translation bound (_search_pad); anything beyond it
        (rotational search) is caught post-match by _ensure_pub_covers."""
        bmin, bmax = self._scan_world_bbox(pose, points, mask)
        pad = self._search_pad()
        self._grow_pub_to_bbox(bmin - pad, bmax + pad)

    def _ensure_pub_covers(self, pose: np.ndarray, points: np.ndarray,
                           mask: np.ndarray):
        """Post-match safety net: if the ACCEPTED pose moved the scan's
        endpoints past the pub extent despite the pre-dispatch pad (a large
        rotational correction can), grow the map and rebuild it exactly
        from the store — the in-step stamp clipped those cells, and a
        re-stamp would double-count the in-bounds ones (count cells are not
        idempotent). Rare by construction; counted in diag."""
        bmin, bmax = self._scan_world_bbox(pose, points, mask)
        spec = self.fspec.pub_spec
        off = self._host_pub_off
        extent = np.array([spec.width, spec.height]) * spec.resolution
        if ((bmin + off >= 0).all() and (bmax + off <= extent).all()):
            return
        self._grow_pub_to_bbox(bmin, bmax)
        self.diag.pub_clip_rebuilds += 1
        with self._state_lock:
            self._rebuild_pub_locked()

    def _rebuild_pub_locked(self):
        """Rebuild the pub map from every stored scan at its current pose
        (InitMapWithRangeVec on the pub map, slam_processor.cpp:350-366).
        Callers hold the state lock."""
        cfg = self.config
        pts, msk, poses, valid = self.store.all_arrays()
        pub = _rebuild_pub_jit(
            self.fspec.pub_spec, self.state.pub.offset, pts, msk, poses,
            valid, jnp.float32(cfg.map_update_free_factor),
            jnp.float32(cfg.map_update_occu_factor),
            first_scan_extra=int(cfg.map_min_passthrough))
        self.state = self.state._replace(pub=pub)
        self._publish_pub_arrays()

    def _grow_pub_to(self, new_w: int, new_h: int,
                     shift_x_cells: int, shift_y_cells: int):
        """Re-allocate the pub map at (new_h, new_w), placing the old
        content ``shift`` cells from the new low edge. Callers hold the
        state lock."""
        spec = self.fspec.pub_spec
        old_hits = np.asarray(self.state.pub.hits)
        old_passes = np.asarray(self.state.pub.passes)
        H, W = old_hits.shape
        hits = np.zeros((new_h, new_w), np.float32)
        passes = np.zeros((new_h, new_w), np.float32)
        hits[shift_y_cells:shift_y_cells + H,
             shift_x_cells:shift_x_cells + W] = old_hits
        passes[shift_y_cells:shift_y_cells + H,
               shift_x_cells:shift_x_cells + W] = old_passes
        new_off = (self._host_pub_off
                   + np.array([shift_x_cells, shift_y_cells]) * spec.resolution)
        self._host_pub_off = new_off
        new_spec = dataclasses.replace(spec, height=new_h, width=new_w)
        self.fspec = dataclasses.replace(self.fspec, pub_spec=new_spec)
        self.bspec = dataclasses.replace(self.bspec, pub_spec=new_spec)
        self.backend.spec = self.bspec
        self.state = self.state._replace(
            pub=CountMap(jnp.asarray(hits), jnp.asarray(passes),
                         jnp.asarray(new_off, jnp.float32)))
        self._publish_pub_arrays()

    def _shift_granule(self) -> float:
        """Smallest shift (m) that is an integer cell count in BOTH
        scan-match maps, so one world-space recenter keeps both lattices.
        lcm(a/b, c/d) = lcm(a·d, c·b) / (b·d)."""
        import math
        from fractions import Fraction

        f = Fraction(str(self.config.fine_map_resolution))
        c = Fraction(str(self.config.coarse_map_resolution))
        num = math.lcm(f.numerator * c.denominator, c.numerator * f.denominator)
        return num / (f.denominator * c.denominator)

    _REBUILD_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)

    def _maybe_recenter(self, pose: np.ndarray):
        """Rolling-window scan-match maps (config.match_map_window): when
        the pose drifts beyond a quarter window from the window center,
        re-center the fine+coarse maps on it. Newly covered area is NOT left
        unknown: the maps are rebuilt from every stored scan whose beams can
        reach the new window, so revisiting a long-left region matches
        against real content exactly like the reference's ever-growing maps
        (grid_map_base.h:188-274) instead of odometry-drifting through
        forgotten cells until the window refills. The pub map keeps the
        global extent (it is the published product)."""
        fs = self.fspec.fine_spec
        extent = np.array([fs.width, fs.height]) * fs.resolution
        off = self._host_fine_off
        center_w = extent * 0.5 - off
        delta = np.asarray(pose[:2]) - center_w
        window = min(float(extent[0]), float(extent[1]))
        if np.max(np.abs(delta)) <= 0.25 * window:
            return
        g = self._shift_granule()
        shift_m = np.round(delta / g) * g                    # (dx, dy) meters
        with self._state_lock:
            self._rebuild_match_maps_at(
                self._host_fine_off - shift_m,
                self._host_coarse_off - shift_m)

    def _rebuild_match_maps_at(self, fine_off: np.ndarray,
                               coarse_off: np.ndarray):
        """Fresh fine+coarse match maps at the given offsets, stamped from
        all stored scans within beam reach of the new window (bucketed batch
        sizes bound recompilation). Callers hold the state lock."""
        cfg = self.config
        fs, cs = self.fspec.fine_spec, self.fspec.coarse_spec
        self._host_fine_off = np.asarray(fine_off, np.float64)
        self._host_coarse_off = np.asarray(coarse_off, np.float64)
        extent = np.array([fs.width, fs.height]) * fs.resolution
        center_new = extent * 0.5 - fine_off
        reach = 0.5 * float(extent.max()) + self.laser.range_threshold
        poses = self.store.poses_array()
        if len(poses):
            d = np.abs(poses[:, :2] - center_new[None]).max(1)
            ids = [int(i) for i in np.flatnonzero(d <= reach)]
        else:
            ids = []
        bucket = next((b for b in self._REBUILD_BUCKETS if b >= len(ids)),
                      max(len(ids), 1))
        pts, msk, sposes, valid = self.store.gather_chain(ids, bucket)
        coarse, fine = _stamp_match_maps(
            cs, fs, jnp.asarray(coarse_off, jnp.float32),
            jnp.asarray(fine_off, jnp.float32), pts, msk, sposes, valid,
            bool(cfg.coarse_map_use_blur), bool(cfg.fine_map_use_blur))
        self.state = self.state._replace(fine=fine, coarse=coarse)

    # ---- async pipeline (the reference's back-end thread) ----

    def _backend_worker(self):
        """Drain the queue batch-wise, exactly the reference's condvar loop
        (BackEndProcessThread, slam_processor.cpp:384-426): graph updates for
        every buffered scan, then one loop-closure pass at the newest."""
        while True:
            item = self._backend_queue.get()
            if item is None:
                return
            batch = [item]
            while True:            # drain without blocking (buffer drain, :405)
                try:
                    batch.append(self._backend_queue.get_nowait())
                except _queue.Empty:
                    break
            if batch[-1] is None:
                batch.pop()
                stop = True
            else:
                stop = False
            t0 = _time.perf_counter()
            with self.timers.stage("backend_update"):
                for sid, cov, pre in batch:
                    pre = self._fresh_prematched(pre)
                    self.backend.update_graph(
                        sid, cov, prematched=(pre or {}).get("near"))
            if batch:
                with self.timers.stage("backend_loop_closure"):
                    last_pre = self._fresh_prematched(batch[-1][2])
                    self.backend.try_close_loop(
                        batch[-1][0],
                        prematched=(last_pre or {}).get("loop"))
            self.diag.loop_closures = self.backend.num_loop_closures
            self.diag.backend_time_s += _time.perf_counter() - t0
            if stop:
                return

    def _ensure_backend_thread(self):
        """(Re)start the worker — finish() joins it, but the engine stays
        usable afterwards (the next async process() revives it)."""
        if self._backend_thread is None or not self._backend_thread.is_alive():
            self._backend_thread = threading.Thread(
                target=self._backend_worker, daemon=True)
            self._backend_thread.start()

    def finish(self):
        """Flush the fetch pipeline and pending back-end work; join the
        async worker if one runs. NOT terminal: further process() calls
        restart the worker automatically."""
        self._drain_pipeline()
        if self._backend_thread is not None and self._backend_thread.is_alive():
            self._backend_queue.put(None)
            self._backend_thread.join()
        self._backend_thread = None

    # ---- corrections (CorrectPoseAndMap, slam_processor.cpp:329-370) ----

    def _apply_corrections(self, corrected: np.ndarray):
        with self._state_lock:
            self._apply_corrections_locked(corrected)

    def _apply_corrections_locked(self, corrected: np.ndarray):
        n_corr = corrected.shape[0]
        n = len(self.store)
        if n_corr == 0 or n == 0:
            return
        if n_corr < n:
            # async mode: scans accepted after the solve snapshot are not in
            # ``corrected``. Re-anchor them with the last corrected scan's
            # rigid delta so their placement relative to the corrected
            # trajectory is preserved before every map is rebuilt around
            # them (the reference corrects EVERY stored scan under the map
            # mutex, CorrectPoseAndMap, slam_processor.cpp:329-370; our
            # snapshot can be stale by the scans that streamed in during
            # the solve).
            old = np.asarray(self.store.poses[n_corr - 1], np.float64)
            new = np.asarray(corrected[n_corr - 1], np.float64)
            dth = new[2] - old[2]
            c_d, s_d = np.cos(dth), np.sin(dth)
            for sid in range(n_corr, n):
                p = np.asarray(self.store.poses[sid], np.float64)
                rel = p[:2] - old[:2]
                th = p[2] + dth
                self.store.set_pose(sid, np.array([
                    new[0] + c_d * rel[0] - s_d * rel[1],
                    new[1] + s_d * rel[0] + c_d * rel[1],
                    np.arctan2(np.sin(th), np.cos(th))]))
        for sid in range(n_corr):
            self.store.set_pose(sid, corrected[sid])
        # corrections move poses arbitrarily (a loop closure can swing the
        # whole trailing trajectory); grow the pub map to the corrected
        # scans' union bbox BEFORE the rebuild so no stamp clips
        # (the reference's rebuild grows per-stamp, grid_map_base.h:257-274)
        bbox = self.store.scans_world_bbox()
        if bbox is not None:
            self._grow_pub_to_bbox(bbox[0], bbox[1], _locked=True)
        pts, msk, poses, valid = self.store.all_arrays()
        cfg = self.config
        pub, coarse, fine = _rebuild_all_maps(
            self.fspec.pub_spec, self.fspec.coarse_spec, self.fspec.fine_spec,
            self.state.pub.offset, self.state.coarse.offset,
            self.state.fine.offset, pts, msk, poses, valid,
            jnp.float32(cfg.map_update_free_factor),
            jnp.float32(cfg.map_update_occu_factor),
            int(cfg.map_min_passthrough), bool(cfg.coarse_map_use_blur),
            bool(cfg.fine_map_use_blur))
        # carry the corrected latest pose forward (deviation from the
        # reference, which leaves current_sensor_pose_ stale across its
        # async boundary; carrying the correction is strictly more robust)
        # mirror through float32 so the host copy equals the device value
        self._host_pose = np.asarray(self.store.poses[-1],
                                     np.float32).astype(np.float64)
        # corrections move the map frame under the odometry: refresh the
        # map→odom transform so pose_at(t) jumps WITH the correction
        # (the reference recomputes it on the next matched scan; doing it
        # here keeps the fixed-rate stream consistent immediately)
        self._update_map_to_odom(self._host_pose,
                                 np.asarray(self.store.odoms[-1], np.float64))
        new_pose = jnp.asarray(self.store.poses[-1], jnp.float32)
        self.state = self.state._replace(
            pub=pub, coarse=coarse, fine=fine, pose=new_pose,
            last_map_update_pose=jnp.array(new_pose))
        for i, (t, _) in enumerate(self.trajectory):
            self.trajectory[i] = (t, self.store.poses[i].copy())
        self._publish_pub_arrays()

    # ---- fixed-rate pose stream (PublishTransform thread analog,
    #      roborts_slam_node.cpp:178-196) ----

    def _update_map_to_odom(self, pose: np.ndarray, odom: np.ndarray):
        """map→odom = pose ∘ odom⁻¹ : the SE(2) transform that carries the
        odometry frame onto the map frame, refreshed whenever a matched
        pose pairs with a known odometry (per kept scan + per correction) —
        the reference computes exactly this after each accepted match
        (roborts_slam_node.cpp:124-135) and broadcasts it at 100 Hz."""
        dth = pose[2] - odom[2]
        c, s = np.cos(dth), np.sin(dth)
        self._map_to_odom = np.array([
            pose[0] - (c * odom[0] - s * odom[1]),
            pose[1] - (s * odom[0] + c * odom[1]),
            dth])

    def _interp_odom(self, t: float) -> np.ndarray | None:
        """Odometry pose at time t, linearly interpolated from the rolling
        history (shortest-arc on the angle); clamps outside the span."""
        h = self._odom_history
        if not h:
            return None
        if t <= h[0][0]:
            return h[0][1].copy()
        if t >= h[-1][0]:
            return h[-1][1].copy()
        for (t0, o0), (t1, o1) in zip(h, h[1:]):
            if t0 <= t <= t1:
                a = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
                dth = np.arctan2(np.sin(o1[2] - o0[2]), np.cos(o1[2] - o0[2]))
                return np.array([o0[0] + a * (o1[0] - o0[0]),
                                 o0[1] + a * (o1[1] - o0[1]),
                                 o0[2] + a * dth])
        return h[-1][1].copy()

    def pose_at(self, t: float) -> np.ndarray:
        """Best pose estimate at an arbitrary time ``t`` — the decoupled
        pose channel the reference serves via its 100 Hz map→odom TF
        broadcast (roborts_slam_node.cpp:178-196): the latest map→odom
        transform (which jumps at corrections) composed with odometry
        interpolated at ``t``, so consumers get a pose BETWEEN kept scans
        without waiting for the next match."""
        o = self._interp_odom(t)
        if o is None or not self.config.use_odometry:
            return self._host_pose.copy()
        tx, ty, dth = self._map_to_odom
        c, s = np.cos(dth), np.sin(dth)
        th = dth + o[2]
        return np.array([tx + c * o[0] - s * o[1],
                         ty + s * o[0] + c * o[1],
                         np.arctan2(np.sin(th), np.cos(th))])

    # ---- outputs ----

    def run_log(self, log, progress: bool = False) -> np.ndarray:
        """Replay a ScanLog; returns the estimated trajectory (N_kept, 4):
        t, x, y, theta."""
        for i in range(len(log)):
            self.process(log.ranges[i], log.odom[i], float(log.times[i]))
            if progress and i % 50 == 0:
                print(f"  scan {i}/{len(log)} kept={len(self.store)} "
                      f"loops={self.backend.num_loop_closures}")
        self.finish()
        return self.trajectory_array()

    def run_stream(self, stream, progress: bool = False) -> np.ndarray:
        """Consume a NativeScanStream (io/native_log.py): points are decoded
        and gated by the native worker ahead of the engine."""
        for i, (idx, pts, msk, nv, t, odom) in enumerate(stream):
            self.process_points(pts, msk, nv, odom, t)
            if progress and i % 50 == 0:
                print(f"  scan {i} kept={len(self.store)} "
                      f"loops={self.backend.num_loop_closures}")
        self.finish()
        return self.trajectory_array()

    def trajectory_array(self) -> np.ndarray:
        return np.array([[t, p[0], p[1], p[2]] for t, p in self.trajectory])

    def get_pub_map(self) -> np.ndarray:
        """Published occupancy grid: -1 unknown / 0 free / 100 occupied
        (PublishMapThread, roborts_slam_node.cpp:427-469)."""
        self._drain_pipeline()
        cfg = self.config
        return np.asarray(count_map_states(self.state.pub,
                                           cfg.map_min_passthrough,
                                           cfg.map_occu_threshold))

    def force_graph_optimize(self):
        self._drain_pipeline()
        self.backend.force_optimize()

    def warm_backend(self, solver_buckets: tuple[int, ...] = (64, 128, 256),
                     match_buckets: tuple[int, ...] | None = None,
                     rebuild_buckets: tuple[int, ...] = (64, 128, 256),
                     calibrate: bool = True):
        """Pre-compile the back end's device programs so the FIRST loop
        closure does not pay jit compilation in the middle of a run.

        The solver and correction programs compile lazily at their first
        shape bucket crossing; with a cold compile cache that lands exactly
        when the first loop closes, inside an otherwise short loop-closure
        call. A real robot warms at boot; call this once after the first
        scan (map offsets exist) and before streaming. All calls are
        side-effect-free: results are discarded and no engine/graph state
        changes. The reference has no analog (Ceres interprets; XLA
        compiles), cf. ceres_pose_graph_solver.cpp:40-45.
        """
        if len(self.store) == 0:
            raise RuntimeError("warm_backend needs >= 1 processed scan")
        self._drain_pipeline()
        from .backend.spa import solve_pose_graph

        def best_effort(fn, what):
            # warming must never be worse than lazy compilation: a failed
            # warm (e.g. a bucket that exceeds device memory on huge-map
            # configs) is reported and skipped, and the live path simply
            # compiles lazily as before
            try:
                fn()
            except Exception as e:  # noqa: BLE001
                import warnings

                warnings.warn(f"warm_backend: skipping {what}: {e!r:.200}",
                              RuntimeWarning)

        # 1. chain-match batch programs (shared by LinkNearChains and both
        #    TryCloseLoop stages). Calibration AOT-compiles each bucket AND
        #    records the compiler's peak memory per bucket, which sets the
        #    live chunking cap (Backend.max_parallel_chains); then warm the
        #    dispatch path at every bucket the chunker can actually emit —
        #    live calls bucket up to the cap, not only (1, 2, 4) (icra
        #    computes a cap of 16, so the first >4-chain scan used to pay a
        #    fresh mid-run compile).
        if calibrate:
            best_effort(lambda: self.backend.calibrate_chain_batch(),
                        "chain-match calibration")
        lim = self.backend.max_parallel_chains()
        step = max((b for b in self.backend._BATCH_BUCKETS if b <= lim),
                   default=1)
        if match_buckets is None:
            match_buckets = tuple(b for b in self.backend._BATCH_BUCKETS
                                  if b <= step)
        for b in match_buckets:
            if b > step:
                continue          # live calls chunk to <= step anyway
            best_effort(lambda b=b: self.backend._match_chain_batch(
                [[0]] * b, 0, self.store.poses[0].copy()),
                f"chain-match bucket {b}")
        # 1b. the FUSED frontend+chain program at the same buckets
        #     (sync fused mode) — AOT lower+compile only: the live program
        #     donates the state and store buffers, so executing it here
        #     would consume them; compilation alone warms the persistent
        #     cache, which is where the cost lives.
        if self._fused_backend and not self.config.use_running_range_scan_match:
            from .backend.processor import (
                fused_frontend_chain_step,
                fused_frontend_chain_step_nodonate,
            )

            fused_fn = (fused_frontend_chain_step if self.synchronous_backend
                        else fused_frontend_chain_step_nodonate)

            def warm_fused(b):
                all_pts, all_msk, all_nv, all_poses, _cap = \
                    self.store.device_arrays(reserve=1)
                K = self.bspec.max_chain_scans
                ids = jnp.asarray(np.full((b, K), -1, np.int32))
                P = self.store.max_points
                compiled = fused_fn.lower(
                    self.fspec, self.bspec, self.state,
                    jnp.zeros((P, 2), jnp.float32), jnp.zeros((P,), bool),
                    jnp.int32(0), jnp.zeros(3, jnp.float32),
                    all_pts, all_msk, all_nv, all_poses, ids,
                    jnp.int32(0)).compile()
                # record the FUSED program's own compiler-measured peak so
                # the fused batch sizer caps with it, not the standalone
                # chain program's smaller footprint
                try:
                    mem = compiled.memory_analysis()
                    peak = (getattr(mem, "peak_memory_in_bytes", 0)
                            or (getattr(mem, "temp_size_in_bytes", 0)
                                + getattr(mem, "output_size_in_bytes", 0)))
                    if peak:
                        self.backend._measured_mem_fused[b] = float(peak)
                except Exception:  # noqa: BLE001 — stats are best-effort
                    pass

            def warm_cursor(b):
                # the pipeline's executable is fused_cursor_step (device
                # append cursor + in-program move gate + lax.cond chain
                # branch) — NOT fused_frontend_chain_step; warming the
                # latter here left the real pipeline program cold and
                # recorded the wrong program's memory peak
                from .backend.processor import fused_cursor_step

                all_pts, all_msk, all_nv, all_poses, _cap = \
                    self.store.device_arrays(reserve=1)
                K = self.bspec.max_chain_scans
                ids = jnp.asarray(np.full((b, K), -1, np.int32))
                P = self.store.max_points
                compiled = fused_cursor_step.lower(
                    self.fspec, self.bspec, self.state,
                    jnp.zeros((P, 2), jnp.float32), jnp.zeros((P,), bool),
                    jnp.int32(0), jnp.zeros(3, jnp.float32),
                    jnp.float32(0.0),
                    all_pts, all_msk, all_nv, all_poses, ids,
                    jnp.zeros((1,), jnp.int32)).compile()
                try:
                    mem = compiled.memory_analysis()
                    peak = (getattr(mem, "peak_memory_in_bytes", 0)
                            or (getattr(mem, "temp_size_in_bytes", 0)
                                + getattr(mem, "output_size_in_bytes", 0)))
                    if peak:
                        self.backend._measured_mem_fused[b] = float(peak)
                except Exception:  # noqa: BLE001 — stats are best-effort
                    pass

            if self.pipelined_fetch and self.synchronous_backend:
                # the pipeline runs ONE executable at a fixed bucket —
                # warm exactly that one (see _process_pipelined)
                b = self._select_pipe_bucket()
                best_effort(lambda: warm_cursor(b),
                            f"pipeline bucket {b}")
            else:
                for b in match_buckets:
                    if b > step:
                        continue
                    best_effort(lambda b=b: warm_fused(b),
                                f"fused bucket {b}")
        # 2. SPA solver shape buckets. The live path buckets nodes and
        #    edges INDEPENDENTLY (as_solver_data), and edges normally
        #    outnumber vertices, so the common live shapes are
        #    (bn, bn) and (bn, 2*bn) — warm both, and gate each dimension
        #    on its own count (a node bucket is still reachable even after
        #    edges outgrow it).
        poses = self.store.poses_array()
        g = self.backend.graph
        for bn in solver_buckets:
            if bn < g.num_vertices:
                continue          # node bucket already outgrown
            for be in (bn, 2 * bn):
                if be < len(g.edges):
                    continue      # edge bucket already outgrown
                data = g.as_solver_data(poses, pad_n=bn, pad_e=be)
                best_effort(lambda d=data: jax.block_until_ready(
                    solve_pose_graph(d)), f"solver bucket ({bn}, {be})")
        # 3. correction map rebuilds at each scan-count capacity bucket the
        #    trajectory may reach (shape-only dummy arrays: compiles key on
        #    shapes, and the device work per warm call — one rebuild from
        #    empty scans — is cheap)
        cfg = self.config
        with self._state_lock:
            pub_off = self.state.pub.offset
            coarse_off = self.state.coarse.offset
            fine_off = self.state.fine.offset

        def rebuilds(cap):
            # the exact program _apply_corrections_locked dispatches
            pts = jnp.zeros((cap, self.store.max_points, 2), jnp.float32)
            msk = jnp.zeros((cap, self.store.max_points), bool)
            poses_j = jnp.zeros((cap, 3), jnp.float32)
            valid = jnp.zeros((cap,), bool)
            out = _rebuild_all_maps(
                self.fspec.pub_spec, self.fspec.coarse_spec,
                self.fspec.fine_spec, pub_off, coarse_off, fine_off,
                pts, msk, poses_j, valid,
                jnp.float32(cfg.map_update_free_factor),
                jnp.float32(cfg.map_update_occu_factor),
                int(cfg.map_min_passthrough), bool(cfg.coarse_map_use_blur),
                bool(cfg.fine_map_use_blur))
            jax.block_until_ready(out)

        for cap in rebuild_buckets:
            best_effort(lambda c=cap: rebuilds(c), f"rebuild bucket {cap}")
