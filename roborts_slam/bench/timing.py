"""Device timing helpers.

Every time here is the host clock around work that ends in a fetch or a
``block_until_ready``: JAX returns before the device finishes, so a timing
without it measures the enqueue. Warm-up calls (compilation included) are
made first and never timed.

- ``time_call``: median and best of repeated calls of one compiled
  function, for a kernel or one engine step.
- ``k_slope_dynamic``: seconds per iteration of a K-iteration chain run in
  ONE compiled program, as the slope between two K points — the fixed
  per-call cost (dispatch, fetch) cancels in the difference.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np


def time_call(f: Callable, *args, reps: int = 10, warmup: int = 2) -> dict:
    """Times ``f(*args)`` (blocked until ready) after ``warmup`` untimed
    calls. Returns seconds: ``median``, ``best`` and every rep in ``reps``."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(f(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t0)
    return {"median": float(np.median(times)), "best": float(min(times)),
            "reps": times}


def k_slope_dynamic(f: Callable, k_points: tuple[int, int] = (16, 64),
                    reps: int = 3, log=None) -> tuple[float, dict]:
    """Seconds per iteration via the two-point K slope with ONE compiled
    program: ``f(seed, K)`` runs K chained iterations where K is a traced
    argument (``lax.fori_loop`` with a dynamic bound), so both K points
    share a single executable; ``seed`` varies the inputs per rep. Returns
    (sec_per_iter, detail) where detail carries the raw times."""
    k1, k2 = k_points
    assert k2 > k1 > 0
    np.asarray(f(0, k1))                   # the one compile + warm
    if log:
        log("compile+warm done")
    totals = {}
    rep_times: dict = {}
    for k in (k1, k2):
        np.asarray(f(1009 + k, k))         # warm this trip count
        times = []
        for i in range(reps):
            t0 = time.perf_counter()
            np.asarray(f(7 * i + k, k))
            times.append(time.perf_counter() - t0)
        totals[k] = min(times)
        rep_times[k] = times
        if log:
            log(f"K={k}: best {totals[k]:.4f}s over {reps} reps")
    sec = max((totals[k2] - totals[k1]) / (k2 - k1), 1e-12)
    return sec, {"t_k1": totals[k1], "t_k2": totals[k2],
                 "k_points": k_points, "rep_times": rep_times}
