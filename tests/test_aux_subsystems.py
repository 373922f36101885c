"""Aux subsystems: log-odds cell model, stage timers, roofline accounting,
the compile cache."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from roborts_slam.models.grid_map import (
    CountMapSpec, log_odds_map_states, log_odds_to_prob, make_log_odds_map,
    prob_to_log_odds,
)
from roborts_slam.ops.raster import update_log_odds_map
from roborts_slam.utils.profiling import (DEVICE_PEAKS, StageTimers,
                                          roofline_report)


def test_log_odds_conversions():
    for p in (0.1, 0.3, 0.5, 0.9):
        lo = prob_to_log_odds(jnp.float32(p))
        np.testing.assert_allclose(float(log_odds_to_prob(lo)), p, atol=1e-6)


def test_log_odds_map_update():
    spec = CountMapSpec(resolution=0.1, height=128, width=128,
                        max_ray_cells=64)
    lmap = make_log_odds_map(spec, offset=[6.4, 6.4])
    P = 16
    pts = np.zeros((P, 2), np.float32)
    pts[:8, 0] = 3.0                      # 8 beams straight +x, 3 m
    msk = np.zeros(P, bool)
    msk[:8] = True
    for _ in range(3):
        lmap = update_log_odds_map(spec, lmap, jnp.asarray(pts),
                                   jnp.asarray(msk), jnp.zeros(3))
    states = np.asarray(log_odds_map_states(lmap))
    # endpoint cell occupied (log-odds(0.9) * 3 > 0)
    ex, ey = int((3.0 + 6.4) / 0.1), int(6.4 / 0.1)
    assert states[ey, ex] == 100
    # mid-ray free, untouched unknown
    assert states[ey, int((1.5 + 6.4) / 0.1)] == 0
    assert states[5, 5] == -1
    # accumulation is additive in log-odds
    lo = float(np.asarray(lmap.log_odds)[ey, ex])
    np.testing.assert_allclose(lo, 3 * np.log(0.9 / 0.1), rtol=1e-5)


def test_stage_timers_report():
    t = StageTimers()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    assert t.stages["a"].count == 2
    assert t.stages["b"].count == 1
    rep = t.report()
    assert "a" in rep and "mean ms" in rep
    d = t.as_dict()
    assert d["a"]["count"] == 2


def test_roofline_report():
    r = roofline_report("corr", seconds=1e-3, flops=1e9, bytes_moved=1e8,
                        device_kind="NVIDIA H100 80GB HBM3")
    np.testing.assert_allclose(r["achieved_tflops"], 1.0)
    np.testing.assert_allclose(r["achieved_gbps"], 100.0)
    np.testing.assert_allclose(r["peak_tflops"], 67.0)      # float32
    np.testing.assert_allclose(r["peak_gbps"], 3350.0)
    assert r["bound"] == "memory"       # 100 GB/s of 3.35 TB/s > 1 of 67 TF
    assert DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]["bf16_tflops"] == 989.0


def test_device_peaks_unknown_device_is_an_error():
    with pytest.raises(KeyError, match="no published peaks"):
        roofline_report("corr", seconds=1e-3, flops=1e9, bytes_moved=1e8,
                        device_kind="cpu")
    assert "cpu" not in DEVICE_PEAKS


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    import jax

    from roborts_slam.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # the variable is JAX's own: the helper sets nothing on top of it
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_repo(monkeypatch):
    import jax

    from roborts_slam.utils import compile_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
