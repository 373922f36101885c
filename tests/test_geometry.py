import numpy as np
import jax.numpy as jnp

from roborts_slam.utils import geometry as geo


def test_normalize_angle():
    for a, want in [(0.0, 0.0), (3 * np.pi, np.pi), (np.pi / 2, np.pi / 2),
                    (-np.pi / 2, -np.pi / 2), (2 * np.pi + 0.1, 0.1),
                    (-7.0, -7.0 + 2 * np.pi)]:
        got = float(geo.normalize_angle(jnp.float64(a) if hasattr(jnp, "float64") else jnp.float32(a)))
        # compare on the circle (±pi boundary is equivalent)
        assert abs(np.sin(got) - np.sin(want)) < 1e-5 and abs(np.cos(got) - np.cos(want)) < 1e-5, (a, got, want)
        assert -np.pi - 1e-5 <= got <= np.pi + 1e-5


def test_compose_inverse_roundtrip():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(16, 3)).astype(np.float32)
    b = rng.normal(size=(16, 3)).astype(np.float32)
    ab = geo.pose_compose(a, b)
    b_back = geo.pose_compose(geo.pose_inverse(a), ab)
    np.testing.assert_allclose(np.asarray(b_back[:, :2]), b[:, :2], atol=1e-4)
    d = np.asarray(geo.normalize_angle(b_back[:, 2] - b[:, 2]))
    np.testing.assert_allclose(d, 0, atol=1e-4)


def test_relative_matches_midframe_semantics():
    # util_test.cpp:21-67 exercises TransformByMidFrame: the relative pose of
    # pose_2 w.r.t. pose_1 in pose_1's frame.
    p1 = jnp.array([1.0, 2.0, np.pi / 4])
    p2 = jnp.array([2.0, 3.0, np.pi / 2])
    rel = geo.pose_relative(p1, p2)
    # recompose
    p2_back = geo.pose_compose(p1, rel)
    np.testing.assert_allclose(np.asarray(p2_back), np.asarray(p2), atol=1e-5)
    # hand-check translation: R(-pi/4) @ [1, 1]
    c = np.cos(-np.pi / 4)
    s = np.sin(-np.pi / 4)
    want = np.array([c * 1 - s * 1, s * 1 + c * 1])
    np.testing.assert_allclose(np.asarray(rel[:2]), want, atol=1e-5)


def test_transform_points():
    pose = jnp.array([1.0, 1.0, np.pi / 2])
    pts = jnp.array([[1.0, 0.0], [0.0, 1.0]])
    out = np.asarray(geo.transform_points(pose, pts))
    np.testing.assert_allclose(out, [[1.0, 2.0], [0.0, 1.0]], atol=1e-5)


def test_predict_pose_by_odom():
    # pure translation: prediction adds the odom delta rotated by yaw offset
    last_pose = jnp.array([1.0, 0.0, np.pi / 2])
    last_odom = jnp.array([5.0, 5.0, 0.0])
    cur_odom = jnp.array([6.0, 5.0, 0.0])  # +1m in odom x
    pred = np.asarray(geo.predict_pose_by_odom(last_pose, last_odom, cur_odom))
    # yaw offset pi/2: odom +x becomes map +y
    np.testing.assert_allclose(pred, [1.0, 1.0, np.pi / 2], atol=1e-5)


def test_pose_change_enough():
    p1 = jnp.array([0.0, 0.0, 0.0])
    assert not bool(geo.pose_change_enough(p1, jnp.array([0.01, 0.0, 0.0]), 0.1, 0.1))
    assert bool(geo.pose_change_enough(p1, jnp.array([0.2, 0.0, 0.0]), 0.1, 0.1))
    assert bool(geo.pose_change_enough(p1, jnp.array([0.0, 0.0, 0.2]), 0.1, 0.1))


def test_bound_box():
    import numpy as np
    from roborts_slam.utils.geometry import (
        bound_box_contains, bound_box_union, points_bound_box)

    pts = jnp.asarray(np.array([[1.0, 2.0], [-1.0, 0.5], [3.0, -2.0],
                                [99.0, 99.0]], np.float32))
    mask = jnp.asarray(np.array([True, True, True, False]))
    mn, mx = points_bound_box(pts, mask)
    np.testing.assert_allclose(np.asarray(mn), [-1.0, -2.0])
    np.testing.assert_allclose(np.asarray(mx), [3.0, 2.0])
    assert bool(bound_box_contains(mn, mx, jnp.asarray([0.0, 0.0])))
    assert not bool(bound_box_contains(mn, mx, jnp.asarray([5.0, 0.0])))
    mn2, mx2 = bound_box_union(mn, mx, jnp.asarray([-4.0, 0.0]),
                               jnp.asarray([0.0, 9.0]))
    np.testing.assert_allclose(np.asarray(mn2), [-4.0, -2.0])
    np.testing.assert_allclose(np.asarray(mx2), [3.0, 9.0])
    # empty mask -> inverted box
    mn3, mx3 = points_bound_box(pts, jnp.zeros(4, bool))
    assert float(mn3[0]) > float(mx3[0])
