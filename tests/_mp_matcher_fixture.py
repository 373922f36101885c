"""Shared matcher problem for the multi-process test: built identically in
the pytest parent (single-process reference) and in every worker, so the
sharded results are comparable bitwise-close."""

import numpy as np


def build_matcher_problem(batch: int = 4, k: int = 4, p: int = 128):
    from roborts_slam.frontend.matchers import MatcherParams
    from roborts_slam.config import SlamConfig
    from roborts_slam.models.grid_map import ProbMapSpec

    cfg = SlamConfig(use_optimize_scan_match=False,
                     coarse_search_space_size=0.4,
                     coarse_search_space_resolution=0.05,
                     coarse_search_angle_offset=0.1,
                     coarse_search_angle_resolution=0.025,
                     coarse_use_point_size=30,
                     fine_search_space_size=0.2,
                     fine_search_space_resolution=0.02,
                     fine_search_angle_offset=0.05,
                     fine_search_angle_resolution=0.025,
                     fine_use_point_size=30,
                     super_fine_search_space_size=0.02,
                     super_fine_search_space_resolution=0.01,
                     super_fine_search_angle_offset=0.01,
                     super_fine_search_angle_resolution=0.005,
                     super_fine_use_point_size=30)
    matcher = MatcherParams.from_config(cfg, use_center_penalty=True)
    fine = ProbMapSpec(0.02, 512, 512, 0.05, 0.88)
    coarse = ProbMapSpec(0.08, 128, 128, 0.24, 0.88)

    rng = np.random.default_rng(42)
    ang = np.linspace(-2.0, 2.0, p)
    r = 3.0 + np.sin(3 * ang)
    base = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)

    chain_pts = np.tile(base[None, None], (batch, k, 1, 1))
    chain_pts += rng.normal(0, 0.002, chain_pts.shape).astype(np.float32)
    chain_msk = np.ones((batch, k, p), bool)
    chain_poses = rng.normal(0, 0.05, (batch, k, 3)).astype(np.float32)
    chain_valid = np.ones((batch, k), bool)
    pts = np.tile(base[None], (batch, 1, 1))
    msk = np.ones((batch, p), bool)
    nv = np.full((batch,), p, np.int32)
    init = rng.normal(0, 0.03, (batch, 3)).astype(np.float32)
    center = np.zeros((batch, 3), np.float32)

    fn_args = (coarse, fine, matcher, True, True)
    arrays = (chain_pts, chain_msk, chain_poses, chain_valid,
              pts, msk, nv, init, center)
    return fn_args, arrays
