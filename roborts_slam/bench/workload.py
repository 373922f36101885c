"""The shared headline-benchmark workload fixture.

ONE definition of the synthetic 3-tier match workload (simulation
parameters, 2048x2048 hash-pattern fine map, willow-beam sinusoid scan)
used by bench.py (chained-match throughput) and chip_smoke.py (parity and
per-tier timing at real widths), so both measure the SAME workload.
"""

from __future__ import annotations

import numpy as np


def headline_workload(beams: int = 1081):
    """Returns a dict with everything a 3-tier scan_match call needs:
    matcher params, fine/coarse specs + prob planes + offsets, packed scan
    points/mask/n_valid, and the init pose. Map content is the pseudo-random
    hash pattern also generated by native/baseline_correlative.cpp (the CPU
    baseline scores identical content in default mode)."""
    import jax.numpy as jnp

    from ..config import SIMULATION_REFERENCE_PROFILE, load_config
    from ..frontend.matchers import MatcherParams
    from ..models.grid_map import ProbMapSpec

    cfg = load_config(SIMULATION_REFERENCE_PROFILE)
    matcher = MatcherParams.from_config(cfg, use_center_penalty=True)
    H = W = 2048
    fine_spec = ProbMapSpec(resolution=0.01, height=H, width=W,
                            deviation=cfg.fine_map_deviation,
                            blur_offset=cfg.gaussian_blur_offset)
    coarse_spec = ProbMapSpec(resolution=0.08, height=256, width=256,
                              deviation=cfg.coarse_map_deviation,
                              blur_offset=cfg.gaussian_blur_offset)
    idx = np.arange(H * W, dtype=np.uint64)
    fine_probs = jnp.asarray(((idx * 2654435761 & 0xFFFF) / 65535.0)
                             .astype(np.float32).reshape(H, W))
    coarse_probs = jnp.full((256, 256), 0.3, jnp.float32)

    ang = np.linspace(-2.35, 2.35, beams)
    r = 3.0 + 2.0 * np.sin(5 * ang)
    P = cfg.max_points
    points = np.zeros((P, 2), np.float32)
    points[:beams, 0] = r * np.cos(ang)
    points[:beams, 1] = r * np.sin(ang)
    mask = np.zeros(P, bool)
    mask[:beams] = True
    return {
        "cfg": cfg, "matcher": matcher,
        "fine_spec": fine_spec, "coarse_spec": coarse_spec,
        "fine_probs": fine_probs, "coarse_probs": coarse_probs,
        "offset": jnp.array([10.24, 10.24], jnp.float32),
        "coff": jnp.array([10.24, 10.24], jnp.float32),
        "points": jnp.asarray(points), "mask": jnp.asarray(mask),
        "n_valid": jnp.int32(beams),
        "init_pose": jnp.array([0.01, 0.0, 0.0], jnp.float32),
    }
