import numpy as np
import jax.numpy as jnp

from roborts_slam.models.grid_map import (
    CountMap, CountMapSpec, ProbMap, ProbMapSpec, count_map_probs,
    count_map_states, make_count_map, make_prob_map,
)
from roborts_slam.ops.raster import (
    dilate_with_kernel, stamp_scan, stamp_scan_batch, update_count_map,
)


def _prob_spec():
    return ProbMapSpec(resolution=0.1, height=128, width=128, deviation=0.24,
                       blur_offset=0.88, default_prob=0.3)


def test_stamp_scan_blur_values():
    spec = _prob_spec()
    pmap = make_prob_map(spec, offset=[6.4, 6.4])
    pts = np.zeros((8, 2), np.float32)
    pts[0] = [1.0, 0.0]
    mask = np.zeros(8, bool)
    mask[0] = True
    pose = jnp.zeros(3)
    out = stamp_scan(spec, pmap, jnp.asarray(pts), jnp.asarray(mask), pose)
    probs = np.asarray(out.probs)
    # endpoint cell: world (1.0, 0) -> map ((1.0+6.4)/0.1, 64) = (74, 64)
    assert probs[64, 74] == 1.0
    # neighbor: kernel * offset, kernel = exp(-0.5*(res/σ)²)
    expect = np.exp(-0.5 * (0.1 / 0.24) ** 2) * 0.88
    np.testing.assert_allclose(probs[64, 75], expect, atol=1e-5)
    np.testing.assert_allclose(probs[65, 74], expect, atol=1e-5)
    # far cell untouched
    assert probs[10, 10] == np.float32(0.3)


def test_stamp_is_max_merge_idempotent():
    spec = _prob_spec()
    pmap = make_prob_map(spec, offset=[6.4, 6.4])
    pts = np.array([[1.0, 0.0], [1.0, 0.05]], np.float32)
    mask = np.ones(2, bool)
    pose = jnp.zeros(3)
    once = stamp_scan(spec, pmap, jnp.asarray(pts), jnp.asarray(mask), pose)
    twice = stamp_scan(spec, once, jnp.asarray(pts), jnp.asarray(mask), pose)
    np.testing.assert_array_equal(np.asarray(once.probs), np.asarray(twice.probs))


def test_batch_stamp_equals_sequential():
    spec = _prob_spec()
    rng = np.random.default_rng(0)
    K, P = 4, 32
    pts = rng.uniform(-3, 3, size=(K, P, 2)).astype(np.float32)
    mask = np.ones((K, P), bool)
    poses = rng.uniform(-1, 1, size=(K, 3)).astype(np.float32)
    base = make_prob_map(spec, offset=[6.4, 6.4])

    seq = base
    for k in range(K):
        seq = stamp_scan(spec, seq, jnp.asarray(pts[k]), jnp.asarray(mask[k]),
                         jnp.asarray(poses[k]))
    bat = stamp_scan_batch(spec, base, jnp.asarray(pts), jnp.asarray(mask),
                           jnp.asarray(poses), jnp.ones(K, bool))
    np.testing.assert_allclose(np.asarray(seq.probs), np.asarray(bat.probs),
                               atol=1e-6)


def test_count_map_carving():
    spec = CountMapSpec(resolution=0.1, height=128, width=128, max_ray_cells=64)
    cmap = make_count_map(spec, offset=[6.4, 6.4])
    pts = np.array([[2.0, 0.0]], np.float32)
    mask = np.ones(1, bool)
    pose = jnp.zeros(3)
    out = update_count_map(spec, cmap, jnp.asarray(pts), jnp.asarray(mask),
                           pose, free_factor=0.0, occu_factor=0.0)
    hits = np.asarray(out.hits)
    passes = np.asarray(out.passes)
    # endpoint (84, 64): hit and pass
    assert hits[64, 84] == 1.0 and passes[64, 84] == 1.0
    # ray cells before endpoint: pass only
    assert hits[64, 70] == 0.0 and passes[64, 70] == 1.0
    assert passes[64, 64] == 1.0  # start cell carved free
    # beyond endpoint untouched
    assert passes[64, 90] == 0.0
    # probs / states
    probs = np.asarray(count_map_probs(out))
    assert probs[64, 84] == 1.0 and probs[64, 70] == 0.0
    states = np.asarray(count_map_states(out, min_passthrough=1, occu_threshold=0.5))
    assert states[64, 84] == 100 and states[64, 70] == 0 and states[0, 0] == -1


def test_dilate_matches_naive():
    rng = np.random.default_rng(1)
    img = (rng.uniform(size=(32, 32)) > 0.9).astype(np.float32)
    k = rng.uniform(0.1, 1.0, size=(5, 5)).astype(np.float32)
    out = np.asarray(dilate_with_kernel(jnp.asarray(img), k))
    ref = np.zeros_like(img)
    for y in range(32):
        for x in range(32):
            best = 0.0
            for dy in range(-2, 3):
                for dx in range(-2, 3):
                    yy, xx = y - dy, x - dx
                    if 0 <= yy < 32 and 0 <= xx < 32:
                        best = max(best, img[yy, xx] * k[dy + 2, dx + 2])
            ref[y, x] = best
    np.testing.assert_allclose(out, ref, atol=1e-6)
