"""ICP tests: mirrors the reference's two-lines convergence test
(slam/src/icp.rs:290-328) plus rotation recovery, masking, step weights."""

import jax.numpy as jnp
import numpy as np
import pytest

from slamrs_tpu.ops import icp


def pad(points, capacity):
    p = jnp.zeros((capacity, 2), jnp.float32)
    return p.at[: len(points)].set(jnp.asarray(points, jnp.float32))


def test_two_lines_translation():
    # icp.rs:296-327: vertical 5-point lines offset by (1, 0)
    pts = [[0.0, 2.0], [0.0, 1.0], [0.0, 0.0], [0.0, -1.0], [0.0, -2.0]]
    p = jnp.asarray(pts, jnp.float32)
    q = p + jnp.array([1.0, 0.0])
    r = icp.icp_point_to_normal(p, jnp.ones(5, bool), q, jnp.int32(5),
                                jnp.zeros(3), iterations=10)
    np.testing.assert_allclose(np.asarray(r.transformation),
                               [1.0, 0.0, 0.0], atol=1e-4)


def test_rotation_recovery():
    rng = np.random.RandomState(0)
    q_np = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    # order points by angle so neighbor normals are meaningful
    q_np = q_np[np.argsort(np.arctan2(q_np[:, 1], q_np[:, 0]))]
    theta = 0.15
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]], np.float32)
    t = np.array([0.05, -0.08], np.float32)
    p_np = (q_np - t) @ R  # so that R p + t == q
    r = icp.icp_point_to_normal(jnp.asarray(p_np), jnp.ones(64, bool),
                                jnp.asarray(q_np), jnp.int32(64),
                                jnp.zeros(3), iterations=15)
    x = np.asarray(r.transformation)
    np.testing.assert_allclose(x, [t[0], t[1], theta], atol=0.02)


def test_padded_reference_lanes_ignored():
    pts = [[0.0, 2.0], [0.0, 1.0], [0.0, 0.0], [0.0, -1.0], [0.0, -2.0]]
    p = jnp.asarray(pts, jnp.float32)
    q = pad(np.asarray(pts) + np.array([1.0, 0.0]), 32)
    r = icp.icp_point_to_normal(p, jnp.ones(5, bool), q, jnp.int32(5),
                                jnp.zeros(3), iterations=10)
    np.testing.assert_allclose(np.asarray(r.transformation),
                               [1.0, 0.0, 0.0], atol=1e-4)


def test_masked_source_points_do_not_contribute():
    pts = [[0.0, 2.0], [0.0, 1.0], [0.0, 0.0], [0.0, -1.0], [0.0, -2.0]]
    p = jnp.asarray(pts + [[50.0, 50.0]], jnp.float32)  # outlier lane
    mask = jnp.array([True] * 5 + [False])
    q = jnp.asarray(pts, jnp.float32) + jnp.array([1.0, 0.0])
    r = icp.icp_point_to_normal(p, mask, q, jnp.int32(5), jnp.zeros(3), 10)
    np.testing.assert_allclose(np.asarray(r.transformation),
                               [1.0, 0.0, 0.0], atol=1e-3)


def test_step_weight_rejects_outliers():
    # Step{threshold} zeroes correspondences with |error| above threshold
    # (icp.rs:29-51)
    pts = np.stack([np.zeros(20), np.linspace(-2, 2, 20)], -1).astype(
        np.float32)
    q = pts + np.array([0.1, 0.0], np.float32)
    p = pts.copy()
    p[10] += np.array([3.0, 0.0], np.float32)  # gross outlier
    r = icp.icp_point_to_normal(jnp.asarray(p), jnp.ones(20, bool),
                                jnp.asarray(q), jnp.int32(20), jnp.zeros(3),
                                iterations=10, step_threshold=0.5)
    x = np.asarray(r.transformation)
    np.testing.assert_allclose(x, [0.1, 0.0, 0.0], atol=0.02)


def test_compute_normals_endpoints_zero():
    q = jnp.asarray([[0, 0], [1, 0], [2, 0], [3, 0]], jnp.float32)
    n = np.asarray(icp.compute_normals(q, jnp.int32(4)))
    assert (n[0] == 0).all() and (n[3] == 0).all()
    np.testing.assert_allclose(np.abs(n[1]), [0, 1], atol=1e-6)


def test_compute_normals_short_sequence_all_zero():
    q = jnp.asarray([[0, 0], [1, 0], [5, 5], [6, 6]], jnp.float32)
    n = np.asarray(icp.compute_normals(q, jnp.int32(2)))
    assert (n == 0).all()


def test_chi_decreases():
    pts = np.stack([np.zeros(30), np.linspace(-2, 2, 30)], -1).astype(
        np.float32)
    q = jnp.asarray(pts) + jnp.array([0.5, 0.0])
    r = icp.icp_point_to_normal(jnp.asarray(pts), jnp.ones(30, bool), q,
                                jnp.int32(30), jnp.zeros(3), iterations=8)
    chi = np.asarray(r.chi_values)
    assert chi[-1] < chi[0] * 0.01


@pytest.mark.parametrize("q_count", [360, 128, 3])
def test_nearest_neighbors_matches_brute_force(q_count):
    """The dense-matrix NN against a numpy brute-force argmin (float64
    distances): the f32 product runs at HIGHEST precision, so only exact
    near-ties could differ — none at these random clouds."""
    import numpy as np

    from slamrs_tpu.ops.icp import nearest_neighbors

    rng = np.random.default_rng(q_count)
    p = rng.normal(size=(4, 360, 2)).astype(np.float32)
    q = rng.normal(size=(4, 360, 2)).astype(np.float32)
    got = np.asarray(nearest_neighbors(jnp.asarray(p), jnp.asarray(q),
                                       jnp.int32(q_count)))
    d2 = ((p[:, :, None, :].astype(np.float64)
           - q[:, None, :q_count, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(got, d2.argmin(-1))
