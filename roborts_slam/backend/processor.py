"""Back-end orchestration: graph update, chain matching, loop closure.

Replacement for the back-end half of ``SlamProcessor`` +
``RangeScanPoseGraph`` (slam_processor.cpp:250-426,
range_scan_pose_graph.cpp:44-355). The reference's back-end thread +
condvar handoff becomes an explicit ``process_pending()`` the engine calls
(synchronously by default — deterministic and testable; an async wrapper
mirrors the reference's pipeline parallelism).

Heavy pieces run on device through two jitted entry points:
- ``chain_match``: rebuild back-end coarse+fine maps from a (padded) chain
  of scans and run the full 3-tier match of the current scan against them —
  the reference's ScanMatchInterface (slam_processor.cpp:250-326) as one
  fused dispatch; vmappable over chains.
- ``solve_pose_graph``: the SPA solve (backend/spa.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..models.grid_map import (
    CountMap, CountMapSpec, ProbMap, ProbMapSpec, backend_map_specs,
    make_prob_map,
)
from ..frontend.matchers import MatcherParams, scan_match
from ..ops.raster import stamp_scan_batch
from ..ops.raycast import map_feedback_penalty
from .pose_graph import PoseGraph
from .spa import solve_pose_graph


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    config: SlamConfig
    coarse_spec: ProbMapSpec
    fine_spec: ProbMapSpec
    pub_spec: CountMapSpec
    matcher: MatcherParams
    max_chain_scans: int

    @staticmethod
    def from_config(config: SlamConfig, laser_range_max: float,
                    pub_spec: CountMapSpec) -> "BackendSpec":
        coarse, fine = backend_map_specs(config, laser_range_max)
        return BackendSpec(
            config=config, coarse_spec=coarse, fine_spec=fine,
            pub_spec=pub_spec,
            # all back-end calls use the front-end matcher params
            # (LinkNearChains/TryCloseLoop pass use_front_end=true,
            # range_scan_pose_graph.cpp:153, :312-318, :329)
            matcher=MatcherParams.from_config(config),
            max_chain_scans=config.max_chain_scans,
        )


def _fused_frontend_chain_impl(fspec, bspec: BackendSpec, state,
                               points, mask, n_valid, cur_odom,
                               all_points, all_masks, all_n_valid, all_poses,
                               chain_ids, store_slot):
    """The front-end step, its LinkNearChains/TryCloseLoop-coarse
    chain-match batch, AND the device-store append in ONE device dispatch.
    The reference runs all of this inside one address space
    (slam_processor.cpp:65-247 then :384-426 via the back-end thread); a
    split would pay three host round-trips per kept scan. The chain
    set is discovered on host from the ODOM-PREDICTED pose before the
    dispatch (PoseGraph.find_near_chains_for_new /
    find_all_loop_candidates_for_new); the matcher's init/center pose and
    the feedback pub map are the MATCHED pose and post-update map from
    this very program, so when the predicted chain set equals the real one
    the results are exactly what the separate chain_match_batch_gather
    dispatch would produce (the engine verifies and falls back otherwise).

    Returns (state, packed, new_store) where ``packed`` is ONE
    (15 + B·13,) f32 vector: the (15,) step summary followed by each
    chain row's pose(3) + score(1) + cov(9). One vector = one host fetch
    per scan INCLUDING fused-step scans.

    The store buffers are DONATED (sync pipeline; the async variant below
    copies) and returned with this scan written at ``store_slot`` (their
    current append cursor): the write is unconditional — if the gate
    rejects the scan the host simply does not advance the cursor, so the
    slot is dead until the next accepted scan overwrites it. Chain gathers
    only read ids < store_slot, so the append never feeds back into this
    dispatch."""
    from ..frontend.processor import frontend_step, pack_step_summary

    state, info = frontend_step(fspec, state, points, mask, n_valid,
                                cur_odom)
    ids = jnp.maximum(chain_ids, 0)
    valid = chain_ids >= 0                              # (B, K)
    cp = all_points[ids]
    cm = all_masks[ids] & valid[..., None]
    cpo = all_poses[ids]
    bpose, bscore, bcov = jax.vmap(
        lambda p_, m_, po_, v_: chain_match(
            bspec, p_, m_, po_, v_, points, mask, n_valid,
            info.pose, info.pose,
            state.pub.hits, state.pub.passes, state.pub.offset)
    )(cp, cm, cpo, valid)
    packed = jnp.concatenate([
        pack_step_summary(info),
        jnp.concatenate([bpose.astype(jnp.float32),
                         bscore[:, None].astype(jnp.float32),
                         bcov.reshape(-1, 9).astype(jnp.float32)],
                        axis=1).reshape(-1),
    ])
    new_store = (
        jax.lax.dynamic_update_index_in_dim(all_points, points,
                                            store_slot, 0),
        jax.lax.dynamic_update_index_in_dim(all_masks, mask, store_slot, 0),
        all_n_valid.at[store_slot].set(n_valid),
        jax.lax.dynamic_update_index_in_dim(all_poses, info.pose,
                                            store_slot, 0),
    )
    return state, packed, new_store


fused_frontend_chain_step = jax.jit(
    _fused_frontend_chain_impl, static_argnames=("fspec", "bspec"),
    donate_argnums=(2, 7, 8, 9, 10))
# async-pipeline variant: the back-end worker thread can concurrently
# dispatch reads of the SAME store buffers (chain_match_batch_gather), so
# donating them would let XLA reuse memory a live dispatch still reads —
# only the state (frontend-thread-owned, lock-protected) is donated. The
# un-donated append copies the (cap, P, 2) buffers on device (~10 MB,
# ~15 us) — invisible next to the ~30 ms fetch it rides behind.
fused_frontend_chain_step_nodonate = jax.jit(
    _fused_frontend_chain_impl, static_argnames=("fspec", "bspec"),
    donate_argnums=(2,))


def _fused_cursor_impl(fspec, bspec: BackendSpec, state,
                       points, mask, n_valid, cur_odom, cur_time,
                       all_points, all_masks, all_n_valid, all_poses,
                       chain_ids, cursor):
    """Pipelined variant of the fused step: the store-append CURSOR lives
    on device — the scan is written at ``cursor[0]`` and the cursor
    advances iff the keep gate passed, so the NEXT dispatch can be issued
    before this scan's summary is fetched (the double-buffered fetch
    pipeline; acceptance is only known at reconcile time). Returns
    (state, packed, new_store, new_cursor) with ``packed`` =
    [15 summary][new cursor][B·13 chain rows]."""
    from ..frontend.processor import frontend_step, pack_step_summary

    # cur_time enables the IN-PROGRAM MoveEnough gate: the pipeline
    # dispatches every scan and the device drops the unmoved ones with
    # the exact last-kept odometry (a host-side gate against lagged
    # mirrors diverged the kept set on the full willow replay)
    state, info = frontend_step(fspec, state, points, mask, n_valid,
                                cur_odom, cur_time)
    slot = cursor[0]
    ids = jnp.maximum(chain_ids, 0)
    valid = chain_ids >= 0
    B = chain_ids.shape[0]

    # the chain batch is conditional IN-PROGRAM: the pipeline dispatches
    # this ONE executable for every scan, and scans with no predicted
    # chains skip the heavy branch on device.
    def with_chains(_):
        cp = all_points[ids]
        cm = all_masks[ids] & valid[..., None]
        cpo = all_poses[ids]
        return jax.vmap(
            lambda p_, m_, po_, v_: chain_match(
                bspec, p_, m_, po_, v_, points, mask, n_valid,
                info.pose, info.pose,
                state.pub.hits, state.pub.passes, state.pub.offset)
        )(cp, cm, cpo, valid)

    def no_chains(_):
        return (jnp.zeros((B, 3), jnp.float32), jnp.zeros((B,), jnp.float32),
                jnp.zeros((B, 3, 3), jnp.float32))

    bpose, bscore, bcov = jax.lax.cond(jnp.any(valid), with_chains,
                                       no_chains, None)
    new_cursor = cursor + info.map_updated.astype(jnp.int32)
    packed = jnp.concatenate([
        pack_step_summary(info),
        new_cursor.astype(jnp.float32),
        jnp.concatenate([bpose.astype(jnp.float32),
                         bscore[:, None].astype(jnp.float32),
                         bcov.reshape(-1, 9).astype(jnp.float32)],
                        axis=1).reshape(-1),
    ])
    new_store = (
        jax.lax.dynamic_update_index_in_dim(all_points, points, slot, 0),
        jax.lax.dynamic_update_index_in_dim(all_masks, mask, slot, 0),
        all_n_valid.at[slot].set(n_valid),
        jax.lax.dynamic_update_index_in_dim(all_poses, info.pose, slot, 0),
    )
    return state, packed, new_store, new_cursor


fused_cursor_step = jax.jit(
    _fused_cursor_impl, static_argnames=("fspec", "bspec"),
    donate_argnums=(2, 8, 9, 10, 11, 13))


@partial(jax.jit, static_argnames=("spec",))
def chain_match_batch_gather(spec: BackendSpec,
                             all_points, all_masks, all_n_valid, all_poses,
                             chain_ids, scan_id, init_poses, center_pose,
                             pub_hits, pub_passes, pub_offset):
    """All candidate chains of one LinkNearChains / TryCloseLoop pass
    matched in ONE device dispatch (vmap over the chain dim; the reference
    loops chains serially, range_scan_pose_graph.cpp:125-164), with the
    scans gathered ON DEVICE from the store's resident buffers
    (ScanStore.device_arrays) by a (B, K) id matrix (-1 = padding).
    Replaces the per-call re-upload of padded host chain arrays (~MBs per
    back-end call); per call the host ships only ids + init poses."""
    ids = jnp.maximum(chain_ids, 0)
    valid = chain_ids >= 0                              # (B, K)
    cp = all_points[ids]                                # (B, K, P, 2)
    cm = all_masks[ids] & valid[..., None]
    cpo = all_poses[ids]
    points = all_points[scan_id]
    mask = all_masks[scan_id]
    n_valid = all_n_valid[scan_id]
    return jax.vmap(
        lambda p_, m_, po_, v_, ip: chain_match(
            spec, p_, m_, po_, v_, points, mask, n_valid, ip,
            center_pose, pub_hits, pub_passes, pub_offset)
    )(cp, cm, cpo, valid, init_poses)


@partial(jax.jit, static_argnames=("spec",))
def chain_match(spec: BackendSpec,
                chain_points, chain_masks, chain_poses, chain_valid,
                points, mask, n_valid, init_pose, center_pose,
                pub_hits, pub_passes, pub_offset):
    """ScanMatchInterface (slam_processor.cpp:250-326) as one device call:
    back-end maps recentered on ``center_pose``
    (ResetScanMatchMapWithRangeVec :448-462), rebuilt from the chain in one
    batched stamp, 3-tier match, then the logistic pub-map penalty (:313-317).
    """
    cfg = spec.config

    def recentered(pspec: ProbMapSpec):
        size_x = pspec.width * pspec.resolution
        size_y = pspec.height * pspec.resolution
        off = jnp.stack([-(center_pose[0] - 0.5 * size_x),
                         -(center_pose[1] - 0.5 * size_y)])
        return make_prob_map(pspec, off)

    coarse = recentered(spec.coarse_spec)
    fine = recentered(spec.fine_spec)
    coarse = stamp_scan_batch(spec.coarse_spec, coarse, chain_points,
                              chain_masks, chain_poses, chain_valid,
                              use_blur=cfg.coarse_map_use_blur)
    fine = stamp_scan_batch(spec.fine_spec, fine, chain_points,
                            chain_masks, chain_poses, chain_valid,
                            use_blur=cfg.fine_map_use_blur)

    out = scan_match(
        spec.matcher,
        spec.fine_spec, fine.probs, fine.offset,
        spec.coarse_spec, coarse.probs, coarse.offset,
        points, mask, n_valid, init_pose,
    )

    if cfg.use_map_check_feedback:
        pub = CountMap(hits=pub_hits, passes=pub_passes, offset=pub_offset)
        penalty = map_feedback_penalty(
            spec.pub_spec, pub, points, mask, n_valid, out.pose,
            cfg.map_check_point_num, cfg.map_check_bound_tolerance,
            cfg.map_check_penalty_gain,
            min_passthrough=jnp.float32(cfg.map_min_passthrough),
            occu_threshold=jnp.float32(cfg.map_occu_threshold),
        )
        # logistic squashing for the back end (slam_processor.cpp:589-591)
        penalty = 1.0 / (1.0 + jnp.exp(-10.0 * (penalty - 0.4)))
        score = jnp.minimum(out.score * penalty, 1.0)
    else:
        score = out.score
    return out.pose, score, out.cov


class Backend:
    """Owns the pose graph; pulls scan data from the engine's store."""

    def __init__(self, spec: BackendSpec, store):
        self.spec = spec
        self.store = store              # engine ScanStore (duck-typed)
        cfg = spec.config
        self.graph = PoseGraph(cfg.link_scan_max_distance,
                               cfg.loop_match_min_chain_size)
        self.on_corrections: Callable | None = None   # set by engine
        self.num_loop_closures = 0
        self.num_links = 0
        # dispatch accounting (BASELINE_MEASURED dispatch-count table)
        self.num_chain_dispatches = 0     # separate chain-match dispatches
        self.num_solves = 0               # SPA solve dispatches
        self.num_fused_hits = 0           # fused chain results accepted
        self.num_fused_misses = 0         # predicted chain set diverged
        # bucket -> compiler-measured peak bytes (calibrate_chain_batch)
        self._measured_mem: dict[int, float] = {}
        # same, for the FUSED frontend+chain program (engine.warm_backend
        # records it while AOT-compiling the fused buckets): the fused
        # program adds the frontend step's map updates + donated store
        # append on top of the chain temps, so a bucket at the standalone
        # boundary can OOM mid-run — the fused batch sizer
        # uses this dict when present
        self._measured_mem_fused: dict[int, float] = {}

    # ---- device-call helpers ----

    _BATCH_BUCKETS = (1, 2, 4, 8, 16)

    @staticmethod
    def device_memory_budget() -> float:
        """Bytes the chain-match batch may plan for, from the runtime's own
        device stats (bytes_limit minus what the engine's maps/store already
        hold). The CPU reports no stats and plans from a 6e9 constant; an
        accelerator that reports no ``bytes_limit`` is an error."""
        dev = jax.local_devices()[0]
        if dev.platform == "cpu":
            return 6e9
        stats = dev.memory_stats() or {}
        limit = stats.get("bytes_limit")
        if not limit:
            raise RuntimeError(
                f"{dev.device_kind} reports no bytes_limit in memory_stats(); "
                "cannot size the chain-match batch")
        # keep 10% headroom for allocator overhead outside our estimate;
        # in_use already includes store + live maps
        return max(2.0e8, 0.9 * limit - stats.get("bytes_in_use", 0))

    def max_parallel_chains(self, fused: bool = False) -> int:
        """Largest chain-match vmap width the device can hold. Preference
        order: (1) the compiler's own per-bucket peak from
        ``calibrate_chain_batch`` (memory_analysis of the compiled
        executable — exact; with ``fused=True`` the FUSED program's own
        measured peaks apply where recorded, since it layers the frontend
        step on top of the same chain temps), (2) the analytic model: each
        chain in the batch materializes its own coarse+fine map rebuild
        (stamp, blur dilation, match slab — ~8 live f32 temps of map size,
        plus a ~2.6x allowance for the compiler's fragmentation). On
        rm-scale maps (30 m lidar, 1 cm fine) a batch of 4 chains needs
        about 16 GB; larger batches are chunked instead."""
        budget = self.device_memory_budget()
        measured = dict(self._measured_mem)
        if fused:
            # the fused peak supersedes the standalone peak per bucket
            measured.update(self._measured_mem_fused)
        if measured:
            safe = [b for b, peak in sorted(measured.items())
                    if peak <= budget]
            if safe:
                return safe[-1]
            return 1
        s = self.spec
        cells = (s.fine_spec.height * s.fine_spec.width
                 + s.coarse_spec.height * s.coarse_spec.width)
        per_chain = cells * 4 * 8 * 2.6
        return int(max(1, min(self._BATCH_BUCKETS[-1], budget // per_chain)))

    def calibrate_chain_batch(self, max_bucket: int | None = None) -> dict:
        """AOT-compile the chain-match program per batch bucket (ascending)
        and record the compiler's peak temp allocation
        (``compiled.memory_analysis()``) — replacing the hand-fit 2.6x
        fragmentation guess with XLA's own number.
        Compiles land in the persistent cache, so this doubles as the
        chain-match warm-up; stops at the first bucket whose measured peak
        exceeds the budget. Returns {bucket: peak_bytes}."""
        st = self.store
        if len(st) == 0:
            raise RuntimeError("calibrate_chain_batch needs >= 1 stored scan")
        budget = self.device_memory_budget()
        heur = self.max_parallel_chains()  # analytic bound before measuring
        all_pts, all_msk, all_nv, all_poses, _cap = st.device_arrays()
        pub_spec, *pub = st.pub_map_arrays()
        spec = (self.spec if pub_spec == self.spec.pub_spec
                else dataclasses.replace(self.spec, pub_spec=pub_spec))
        K = self.spec.max_chain_scans
        for b in self._BATCH_BUCKETS:
            if max_bucket is not None and b > max_bucket:
                break
            if self._measured_mem:
                # peaks scale ~linearly in B (per-chain map temps dominate);
                # don't pay a compile for a bucket the last
                # measurement already puts far past the budget
                last_b = max(self._measured_mem)
                if self._measured_mem[last_b] * (b / last_b) > 1.5 * budget:
                    break
            elif b > 4 * max(heur, 1):
                break    # analytic model says far past the cliff: stop
            ids = np.full((b, K), -1, np.int32)
            ids[:, 0] = 0
            try:
                lowered = chain_match_batch_gather.lower(
                    spec, all_pts, all_msk, all_nv, all_poses,
                    jnp.asarray(ids), jnp.int32(0),
                    jnp.zeros((b, 3), jnp.float32),
                    jnp.zeros(3, jnp.float32), *pub)
                compiled = lowered.compile()
                mem = compiled.memory_analysis()
                # XLA reports the buffer-assignment peak on the GPU and the
                # CPU; temps + outputs cover a backend that does not
                peak = (getattr(mem, "peak_memory_in_bytes", 0)
                        or (getattr(mem, "temp_size_in_bytes", 0)
                            + getattr(mem, "output_size_in_bytes", 0)))
                if not peak:
                    break    # backend reports no analysis: keep heuristic
                self._measured_mem[b] = float(peak)
                if peak > budget:
                    break
            except Exception:  # noqa: BLE001 — OOM/unsupported: stop probing
                break
        return dict(self._measured_mem)

    def _match_chain_batch(self, chain_id_lists: list[list[int]],
                           scan_id: int, init_poses: np.ndarray):
        # chunk to the largest BUCKET <= the memory cap, not the raw cap:
        # _match_chain_batch_one pads each chunk up to the next bucket, so
        # chunking by a non-bucket cap (e.g. 6) would dispatch a padded
        # width (8) past the cap — the exact OOM the cap exists to prevent
        lim = self.max_parallel_chains()
        step = max((b for b in self._BATCH_BUCKETS if b <= lim), default=1)
        if len(chain_id_lists) > step:
            out = []
            inits = np.asarray(init_poses, np.float32)
            for i in range(0, len(chain_id_lists), step):
                chunk_inits = inits if inits.ndim == 1 else inits[i:i + step]
                out += self._match_chain_batch_one(
                    chain_id_lists[i:i + step], scan_id, chunk_inits)
            return out
        return self._match_chain_batch_one(chain_id_lists, scan_id,
                                           init_poses)

    def _match_chain_batch_one(self, chain_id_lists: list[list[int]],
                               scan_id: int, init_poses: np.ndarray):
        """Match one scan against B chains in a single dispatch, gathering
        the scans from the store's device-resident buffers (the host ships
        only a (B, K) id matrix + init poses per call). B pads up to a
        bucket size (bounded recompilation); padded slots carry empty
        chains (-1 ids), whose near-default score falls below every link
        threshold. ``init_poses``: (3,) shared, or (B, 3) per-chain."""
        st = self.store
        K = self.spec.max_chain_scans
        B = len(chain_id_lists)
        bucket = next(b for b in self._BATCH_BUCKETS if b >= B) \
            if B <= self._BATCH_BUCKETS[-1] else B
        inits = np.asarray(init_poses, np.float32)
        if inits.ndim == 1:
            inits = np.tile(inits[None], (bucket, 1))
        else:
            assert inits.shape[0] == B
            inits = np.concatenate(
                [inits, np.zeros((bucket - B, 3), np.float32)])
        ids = np.full((bucket, K), -1, np.int32)
        for b, chain in enumerate(chain_id_lists):
            ids[b, :min(len(chain), K)] = chain[:K]
        self.num_chain_dispatches += 1
        all_pts, all_msk, all_nv, all_poses, _cap = st.device_arrays()
        # ONE atomic snapshot tuple: (pub_spec, hits, passes, offset). The
        # pub map can grow mid-run (engine._grow_pub_to); pairing arrays
        # with the spec they were built under keeps this thread consistent
        # even if the engine swaps both while we run.
        pub_spec, *pub = st.pub_map_arrays()
        spec = (self.spec if pub_spec == self.spec.pub_spec
                else dataclasses.replace(self.spec, pub_spec=pub_spec))
        out = chain_match_batch_gather(
            spec, all_pts, all_msk, all_nv, all_poses,
            jnp.asarray(ids), jnp.int32(scan_id), jnp.asarray(inits),
            jnp.asarray(st.poses[scan_id], jnp.float32),
            *pub,
        )
        # ONE host fetch for all three results: each separate np.asarray is
        # its own device round-trip
        bpose, bscore, bcov = jax.device_get(out)
        bpose = bpose.astype(np.float64)
        bscore = bscore.astype(np.float64)
        bcov = bcov.astype(np.float64)
        return [(bpose[i], float(bscore[i]), bcov[i]) for i in range(B)]

    # ---- graph construction (UpdateGraph, range_scan_pose_graph.cpp:44-78) ----

    def update_graph(self, scan_id: int, covariance: np.ndarray,
                     prematched=None):
        """``prematched``: optional ``(chains, results)`` from the fused
        frontend dispatch — the chain set discovered from the PREDICTED
        pose and its match results. Used instead of a separate dispatch iff
        the real (matched-pose) discovery returns the identical chain set.
        """
        vid = self.graph.add_vertex()
        assert vid == scan_id, (vid, scan_id)
        if scan_id > 0:
            self._link_scans(scan_id - 1, scan_id,
                             self.store.poses[scan_id], covariance)
            self._link_near_chains(scan_id, prematched=prematched)

    def _link_scans(self, source: int, target: int, mean: np.ndarray,
                    covariance: np.ndarray):
        """LinkScans (range_scan_pose_graph.cpp:102-118): edge from the
        source scan's pose to ``mean`` with the given covariance."""
        if self.graph.add_edge(source, target, self.store.poses[source],
                               mean, covariance):
            self.num_links += 1

    def _link_near_chains(self, scan_id: int, prematched=None):
        """LinkNearChains (range_scan_pose_graph.cpp:120-167); all eligible
        chains are matched in one batched dispatch (vmap; shardable across
        the data mesh axis) — or consumed from the fused
        frontend dispatch when the predicted chain set held."""
        cfg = self.spec.config
        bary = self.store.barycenters()
        chains = [c for c in self.graph.find_near_chains(scan_id, bary)
                  if len(c) >= cfg.loop_match_min_chain_size]
        if not chains:
            return
        if prematched is not None and prematched[0] == chains:
            results = prematched[1]
            self.num_fused_hits += 1
        else:
            if prematched is not None:
                self.num_fused_misses += 1
            init = self.store.poses[scan_id].copy()
            results = self._match_chain_batch(
                [PoseGraph.sparsify_chain(c) for c in chains], scan_id, init)
        for chain, (pose, response, cov) in zip(chains, results):
            if not np.all(np.isfinite(cov)):
                continue
            if response > cfg.link_match_min_response:
                self._link_chain_to_scan(chain, scan_id, pose, cov)

    def _link_chain_to_scan(self, chain: list[int], scan_id: int,
                            mean: np.ndarray, covariance: np.ndarray) -> int:
        """LinkChainToScan (range_scan_pose_graph.cpp:169-190)."""
        bary = self.store.barycenters()
        closest = PoseGraph.find_closest_scan_id(chain, scan_id, bary)
        d2 = float(np.sum((bary[scan_id, :2] - bary[closest, :2]) ** 2))
        if d2 < self.spec.config.link_scan_max_distance**2:
            self._link_scans(closest, scan_id, mean, covariance)
        return closest

    # ---- loop closure (TryCloseLoop, range_scan_pose_graph.cpp:299-355) ----

    def try_close_loop(self, scan_id: int, prematched=None) -> bool:
        """TryCloseLoop with batched verification: ALL candidate chains are
        coarse-matched in one device dispatch (the reference — and round 1 —
        matched them one at a time, range_scan_pose_graph.cpp:299-355), the
        survivors fine-matched in a second dispatch, and the first fine
        acceptance closes the loop. A closure corrects every pose, so the
        remaining candidates are re-discovered against the corrected
        barycenters (the accepted chain becomes graph-linked and drops out),
        matching the reference's rescan-after-correction behavior."""
        cfg = self.spec.config
        closed = False
        for _round in range(8):        # closures per scan are few; bound it
            bary = self.store.barycenters()
            chains = self.graph.find_all_loop_candidates(scan_id, bary)
            if not chains:
                break
            if (_round == 0 and prematched is not None
                    and prematched[0] == chains):
                # the coarse verification rode the fused frontend dispatch
                coarse = prematched[1]
                self.num_fused_hits += 1
            else:
                if _round == 0 and prematched is not None:
                    self.num_fused_misses += 1
                init = self.store.poses[scan_id].copy()
                coarse = self._match_chain_batch(chains, scan_id, init)
            passing = [
                (chain, pose) for chain, (pose, resp, cov) in zip(chains, coarse)
                if (resp > cfg.loop_match_min_response_coarse
                    and cov[0, 0] < cfg.loop_match_max_variance_coarse
                    and cov[1, 1] < cfg.loop_match_max_variance_coarse)
            ]
            if not passing:
                break
            # fine re-match from each coarse pose (second verification stage,
            # range_scan_pose_graph.cpp:329-333) — one dispatch for all
            fine_results = self._match_chain_batch(
                [c for c, _ in passing], scan_id,
                np.stack([p for _, p in passing]).astype(np.float32))
            fine = [(chain,) + res
                    for (chain, _), res in zip(passing, fine_results)]
            accepted = False
            for chain, fine_pose, fine_resp, fine_cov in fine:
                if fine_resp >= cfg.loop_match_min_response_fine:
                    self.store.set_pose(scan_id, fine_pose)
                    self._link_chain_to_scan(chain, scan_id, fine_pose,
                                             fine_cov)
                    self._solve_and_correct()
                    closed = True
                    accepted = True
                    self.num_loop_closures += 1
                    break          # corrections moved everything: re-discover
            if not accepted:
                break
        return closed

    def force_optimize(self):
        """ForceComputeByCeres equivalent (range_scan_pose_graph.cpp:400-407)."""
        if self.graph.num_vertices > 1:
            self._solve_and_correct()

    def _solve_and_correct(self):
        self.num_solves += 1
        data = self.graph.as_solver_data(self.store.poses_array())
        poses, cost, iters = solve_pose_graph(data)
        corrected = np.asarray(poses, np.float64)[: self.graph.num_vertices]
        if self.on_corrections is not None:
            self.on_corrections(corrected)

    def graph_info(self):
        """GetGraphInfo equivalent: (node xy array, edge endpoint pairs)."""
        poses = self.store.poses_array()
        nodes = poses[: self.graph.num_vertices, :2]
        edges = [(poses[e.source, :2], poses[e.target, :2])
                 for e in self.graph.edges]
        return nodes, edges
