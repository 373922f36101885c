"""Sharded batch scan matching — DP fan-out over chains / scans.

The reference matches one chain at a time on one CPU thread
(range_scan_pose_graph.cpp:125-164). Here a whole batch of independent
chain-match problems (back-end link candidates, loop-closure verifications,
or plain scans for the throughput benchmark) is vmapped and sharded across
the ``data`` mesh axis: every device rebuilds the chain maps for its slice
of the batch and runs the 3-tier correlative match — zero cross-device
communication until the small result gather.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..frontend.matchers import scan_match
from ..models.grid_map import ProbMapSpec, make_prob_map
from ..ops.raster import stamp_scan_batch


def _single_chain_match(spec_coarse: ProbMapSpec, spec_fine: ProbMapSpec,
                        matcher, use_blur_coarse: bool, use_blur_fine: bool,
                        chain_points, chain_masks, chain_poses, chain_valid,
                        points, mask, n_valid, init_pose, center_pose):
    def recentered(pspec: ProbMapSpec):
        size_x = pspec.width * pspec.resolution
        size_y = pspec.height * pspec.resolution
        off = jnp.stack([-(center_pose[0] - 0.5 * size_x),
                         -(center_pose[1] - 0.5 * size_y)])
        return make_prob_map(pspec, off)

    coarse = stamp_scan_batch(spec_coarse, recentered(spec_coarse),
                              chain_points, chain_masks, chain_poses,
                              chain_valid, use_blur=use_blur_coarse)
    fine = stamp_scan_batch(spec_fine, recentered(spec_fine),
                            chain_points, chain_masks, chain_poses,
                            chain_valid, use_blur=use_blur_fine)
    out = scan_match(matcher, spec_fine, fine.probs, fine.offset,
                     spec_coarse, coarse.probs, coarse.offset,
                     points, mask, n_valid, init_pose)
    return out.pose, out.score, out.cov


def make_batched_chain_matcher(spec_coarse: ProbMapSpec, spec_fine: ProbMapSpec,
                               matcher, use_blur_coarse: bool,
                               use_blur_fine: bool,
                               mesh: Mesh | None = None,
                               axis: str = "data"):
    """Returns a jitted fn over leading batch dim B:
    (B,K,P,2),(B,K,P),(B,K,3),(B,K),(B,P,2),(B,P),(B,),(B,3),(B,3)
      -> poses (B,3), scores (B,), covs (B,3,3).
    With a mesh, the batch dim is sharded across ``axis``."""
    f = partial(_single_chain_match, spec_coarse, spec_fine, matcher,
                use_blur_coarse, use_blur_fine)
    vf = jax.vmap(f)
    if mesh is None:
        return jax.jit(vf)
    shard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    in_sh = (shard,) * 9
    out_sh = (shard, shard, shard)
    return jax.jit(vf, in_shardings=in_sh, out_shardings=out_sh)


def make_sharded_chain_matcher_gather(spec, mesh: Mesh, axis: str = "data"):
    """Sharded twin of ``backend.processor.chain_match_batch_gather``: the
    (B, K) chain-id matrix, per-chain init poses, and the outputs are
    sharded across ``axis``; the store's device-resident scan buffers and
    the pub map are replicated. GSPMD then partitions the vmap over
    chains, so EACH DEVICE materializes only B/n_devices chains' map-pair
    temps — the per-chain coarse+fine rebuild is the back end's memory
    cliff at rm scale. There is no cross-device communication until the
    (B, 3)/(B,)/(B, 3, 3) result gather.

    ``spec``: a BackendSpec. Call with the same operands as
    chain_match_batch_gather; B must be a multiple of the mesh axis size.

    Ref workload: the LinkNearChains / TryCloseLoop chain fan-out,
    range_scan_pose_graph.cpp:125-164.
    """
    from ..backend.processor import chain_match

    def batched(all_points, all_masks, all_n_valid, all_poses,
                chain_ids, scan_id, init_poses, center_pose,
                pub_hits, pub_passes, pub_offset):
        ids = jnp.maximum(chain_ids, 0)
        valid = chain_ids >= 0                              # (B, K)
        cp = all_points[ids]
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

    shard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    in_sh = (rep, rep, rep, rep, shard, rep, shard, rep, rep, rep, rep)
    return jax.jit(batched, in_shardings=in_sh,
                   out_shardings=(shard, shard, shard))


def make_batched_scan_matcher(spec_fine: ProbMapSpec, spec_coarse: ProbMapSpec,
                              matcher, mesh: Mesh | None = None,
                              axis: str = "data"):
    """Batch of scans matched against ONE replicated map pyramid — the
    scans/sec throughput benchmark kernel and the loop-closure candidate
    prefilter. Batch dim sharded across ``axis``; map replicated."""

    def one(fine_probs, fine_off, coarse_probs, coarse_off,
            points, mask, n_valid, init_pose):
        out = scan_match(matcher, spec_fine, fine_probs, fine_off,
                         spec_coarse, coarse_probs, coarse_off,
                         points, mask, n_valid, init_pose)
        return out.pose, out.score, out.cov

    vf = jax.vmap(one, in_axes=(None, None, None, None, 0, 0, 0, 0))
    if mesh is None:
        return jax.jit(vf)
    shard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    in_sh = (rep, rep, rep, rep, shard, shard, shard, shard)
    out_sh = (shard, shard, shard)
    return jax.jit(vf, in_shardings=in_sh, out_shardings=out_sh)
