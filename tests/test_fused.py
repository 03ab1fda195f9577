"""Fused RBPF update: the production formulations vs the oracle, plus
pipeline behavior.

The plain XLA version runs as compiled here; the Triton kernel runs in
Pallas interpret mode on the CPU (compiled on the GPU by chip_smoke.py
and the chip-marked tests).
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slamrs_tpu.core.types import OdometryReading, Scan
from slamrs_tpu.models import gridslam as gs
from slamrs_tpu.ops import fused
from slamrs_tpu.ops.fused import (encode_beam_table, fused_update_reference,
                                  fused_update_triton, fused_update_xla,
                                  window_rows)
from slamrs_tpu.ops.grid import GridSpec2D, grid_integrate_dense, \
    grid_log_likelihood, dense_window_for

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import grid_mismatch, window_cells  # noqa: E402

SPEC = GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05)
B = 360


def _mk(p=3, seed=0):
    grids = jax.random.normal(jax.random.key(seed), (p, 80, 128),
                              jnp.float32) * 0.5
    grids = grids.at[:, ::3, ::2].set(0.0)
    poses = jnp.stack([
        jax.random.uniform(jax.random.key(seed + 1), (p,), jnp.float32,
                           -1.3, 1.3),
        jax.random.uniform(jax.random.key(seed + 2), (p,), jnp.float32,
                           -1.3, 1.3),
        jax.random.uniform(jax.random.key(seed + 3), (p,), jnp.float32,
                           -3.0, 3.0)], axis=-1)
    dist = jax.random.uniform(jax.random.key(seed + 4), (B,), jnp.float32,
                              0.1, 1.0)
    valid = jax.random.bernoulli(jax.random.key(seed + 5), 0.8, (B,))
    present = jnp.ones((B,), bool).at[350:].set(False)
    return grids, poses, dist, valid, present


def test_kernel_matches_oracle_interpret():
    grids, poses, dist, valid, present = _mk()
    a0 = jnp.float32(0.0)
    g1, l1 = fused_update_triton(grids, poses, a0, dist, valid, present,
                                 SPEC, B, 1.0, interpret=True)
    g2, l2 = fused_update_reference(grids, poses, a0, dist, valid, present,
                                    SPEC, B, 1.0)
    flips, _ = grid_mismatch(g1, g2)
    assert flips <= 1e-4 * window_cells(SPEC, 1.0, 3), flips
    # the endpoint likelihood is the same exact formulation in both
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2),
                               rtol=1e-5, atol=1e-4)


def test_oracle_matches_dense_integrate():
    """The fused sensor model must agree with grid_integrate_dense on the
    window region (same inverse sensor model + multiplicity compensation)."""
    grids, poses, dist, valid, present = _mk(p=2, seed=7)
    a0 = jnp.float32(0.0)
    angles = jnp.arange(B, dtype=jnp.float32) * (2 * np.pi / B)
    g2, _ = fused_update_reference(grids, poses, a0, dist, valid, present,
                                   SPEC, B, 1.0)
    window = dense_window_for(SPEC, 1.0)
    dense = jax.vmap(lambda g, q: grid_integrate_dense(
        g[:, :SPEC.cols], SPEC, q, angles, dist, valid, present, window)
    )(grids, poses)
    # compare increments on the logical grid
    inc_f = np.asarray(g2[:, :, :SPEC.cols] - grids[:, :, :SPEC.cols])
    inc_d = np.asarray(dense - grids[:, :, :SPEC.cols])
    # same support + same classification for nearly all cells (different
    # angular rasterization -> sub-cell boundary flips allowed)
    agree = (np.abs(inc_f - inc_d) < 0.05) | \
            (np.sign(inc_f) == np.sign(inc_d))
    assert agree.mean() > 0.98, f"agreement {agree.mean()}"


def test_endpoint_likelihood_exact():
    """The fused likelihood IS the reference per-beam endpoint product:
    it must match grid_log_likelihood (the exact map.rs:113-145 port) up
    to float-associativity cell-boundary flips in the endpoint rounding.
    """
    grids, poses, dist, valid, present = _mk(p=8, seed=11)
    a0 = jnp.float32(0.0)
    angles = jnp.arange(B, dtype=jnp.float32) * (2 * np.pi / B)
    _, lik_f = fused_update_reference(grids, poses, a0, dist, valid,
                                      present, SPEC, B, 1.0)
    lik_ref = jax.vmap(lambda g, q: grid_log_likelihood(
        g[:, :SPEC.cols], SPEC, q, angles, dist, valid, present)
    )(grids, poses)
    lf = np.asarray(lik_f)
    lr = np.asarray(lik_ref)
    assert np.all(lf < 0) and np.all(lr < 0)
    # per-particle: the two formulations round endpoint coordinates with
    # different op orders ((x-px)/res + cos*d/res vs (x+cos*d-px)/res);
    # at most a couple of boundary beams may land in a neighboring cell
    per_beam_bound = abs(np.log(0.1))  # max |log factor| swing per beam
    assert np.abs(lf - lr).max() < 3 * per_beam_bound, (lf, lr)
    assert np.abs(lf - lr).mean() < 0.5


def _spearman(a, b):
    ra = np.argsort(np.argsort(a))
    rb = np.argsort(np.argsort(b))
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    return float((ra * rb).sum()
                 / np.sqrt((ra * ra).sum() * (rb * rb).sum()))


def test_likelihood_rank_correlation_gate():
    """Ordering-level fidelity gate (what resampling selection sees):
    over 100 random (grids, poses) states, Spearman rank correlation
    between the fused likelihood and grid_log_likelihood must be >= 0.95
    per state, and the induced N_eff must agree closely."""
    from slamrs_tpu.ops.resample import (effective_particles,
                                         normalize_log_weights)

    angles = jnp.arange(B, dtype=jnp.float32) * (2 * np.pi / B)
    p = 16
    n_states = 100
    grids_all, poses_all, dist_all, valid_all, present_all = [], [], [], [], []
    for s in range(n_states):
        g, q, d, v, pr = _mk(p=p, seed=100 + 7 * s)
        grids_all.append(g)
        poses_all.append(q)
        dist_all.append(d)
        valid_all.append(v)
        present_all.append(pr)
    grids_all = jnp.stack(grids_all)
    poses_all = jnp.stack(poses_all)

    fused_b = jax.jit(jax.vmap(
        lambda g, q, d, v, pr: fused_update_reference(
            g, q, jnp.float32(0.0), d, v, pr, SPEC, B, 1.0)[1]))
    lik_f = np.asarray(fused_b(grids_all, poses_all,
                               jnp.stack(dist_all), jnp.stack(valid_all),
                               jnp.stack(present_all)))
    lik_r = np.zeros_like(lik_f)
    for s in range(n_states):
        lik_r[s] = np.asarray(jax.vmap(
            lambda g, q, s=s: grid_log_likelihood(
                g[:, :SPEC.cols], SPEC, q, angles, dist_all[s],
                valid_all[s], present_all[s]))(grids_all[s], poses_all[s]))

    rhos = np.array([_spearman(lik_f[s], lik_r[s])
                     for s in range(n_states)])
    assert (rhos >= 0.95).all(), f"min Spearman {rhos.min()}"
    # N_eff agreement: the resampling trigger must see the same degeneracy
    w_f = np.asarray(normalize_log_weights(jnp.asarray(lik_f)))
    w_r = np.asarray(normalize_log_weights(jnp.asarray(lik_r)))
    neff_f = np.asarray(effective_particles(jnp.asarray(w_f)))
    neff_r = np.asarray(effective_particles(jnp.asarray(w_r)))
    rel = np.abs(neff_f - neff_r) / neff_r
    assert np.median(rel) < 0.05, f"median N_eff rel err {np.median(rel)}"
    assert rel.max() < 0.35, f"max N_eff rel err {rel.max()}"


def test_gridslam_update_fused_runs():
    cfg = gs.GridSlamConfig(position_x=-2, position_y=-2, width=4.0,
                            height=4.0, resolution=0.05, n_particles=8,
                            max_scan_range=1.0, integrate="fused",
                            resample_neff_frac=0.5)
    state = gs.GridSlamState.init(cfg)
    assert state.grids.shape == (8, 80, 80)  # the logical grid, unpadded
    angles = jnp.arange(B, dtype=jnp.float32) * (2 * np.pi / B)
    scan = Scan(angles=angles,
                distances=jnp.full((B,), 0.8, jnp.float32),
                strengths=jnp.ones((B,), jnp.float32),
                valid=jnp.ones((B,), bool),
                present=jnp.ones((B,), bool))
    odo = OdometryReading(jnp.float32(0.01), jnp.float32(0.012),
                          jnp.float32(0.1))
    state2, out = gs.update(state, scan, odo, jax.random.key(0), cfg)
    assert np.isfinite(float(out.n_eff))
    assert state2.grids.dtype == state.grids.dtype
    # the map must have changed inside the scan disc
    assert float(jnp.abs(state2.grids).sum()) > 0

    prob = gs.estimated_probability_grid(state2)
    assert prob.shape == (80, 80)
    assert float(prob.min()) >= 0.0 and float(prob.max()) <= 1.0


def test_encode_beam_table_flags():
    d = jnp.array([0.5, 0.7, 0.0, 0.9], jnp.float32)
    valid = jnp.array([True, False, True, True])
    present = jnp.array([True, True, True, False])
    t = encode_beam_table(d, valid, present)[0]
    assert float(t[0]) == np.float32(0.5)        # valid hit
    assert float(t[1]) == float(np.float32(-0.7))  # invalid, present
    assert float(t[2]) > 0              # zero-distance valid -> epsilon
    assert float(t[3]) == 0.0 and np.signbit(float(t[3]))  # absent -> -0.0
    assert t.shape == (5,)  # one absent slot past the beams
    assert float(t[4]) == 0.0 and np.signbit(float(t[4]))  # padding


def test_window_rows_covers_disc():
    wr = window_rows(SPEC, 1.0)
    disc = 2 * (int(np.ceil(1.0 / SPEC.resolution)) + 3) + 1
    assert wr % 8 == 0 and wr >= min(disc, SPEC.rows)


def test_static_bin_pipeline_matches_traced():
    """The static-dphi bin-units pipeline (1/dphi folded into the angle,
    floor-form rounding — ops/fused._cell_pass) must agree with the
    traced-dphi pipeline of the SAME spacing: bin assignments identical
    except ulp-scale rounding-path boundary flips, and the endpoint
    likelihood (independent of the bin pipeline) tight."""
    grids, poses, dist, valid, present = _mk(p=4, seed=11)
    a0 = jnp.float32(0.1)
    dphi = 2 * np.pi / B
    g_s, l_s = fused_update_xla(grids, poses, a0, dist, valid, present,
                                SPEC, B, 1.0, dphi=dphi)
    g_t, l_t = fused_update_xla(grids, poses, a0, dist, valid, present,
                                SPEC, B, 1.0, dphi=jnp.float32(dphi))
    cells = window_cells(SPEC, 1.0, 4)
    flips, _ = grid_mismatch(g_s, g_t)
    assert flips <= 1e-4 * cells, f"static-vs-traced flips {flips}"
    np.testing.assert_allclose(np.asarray(l_s), np.asarray(l_t),
                               rtol=1e-5, atol=1e-4)
    # the traced path must ALSO still match the traced oracle (the
    # static branch must not rot the generic pipeline)
    g_o, l_o = fused_update_reference(grids, poses, a0, dist, valid,
                                      present, SPEC, B, 1.0,
                                      dphi=jnp.float32(dphi))
    flips_o, _ = grid_mismatch(g_t, g_o)
    assert flips_o <= 1e-4 * cells, f"traced-vs-oracle flips {flips_o}"
    np.testing.assert_allclose(np.asarray(l_t), np.asarray(l_o),
                               rtol=1e-5, atol=1e-4)


# ---- production formulations vs the oracle, per geometry --------------

def _case(name, dtype):
    """(spec, grids, poses, angles0, distances, valid, present, num_beams,
    dphi) for one parity geometry; every beam stays within max range."""
    rng = np.random.default_rng(GEOMETRIES.index(name))
    spec, p, nb, dphi = {
        "0.05m": (GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05), 6, 360, None),
        "0.02m": (GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.02), 4, 360, None),
        "20m": (GridSpec2D(-10.0, -10.0, 20.0, 20.0, 0.05), 4, 360, None),
        "50m": (GridSpec2D(-25.0, -25.0, 50.0, 50.0, 0.05), 2, 360, None),
        "edges": (GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05), 8, 360, None),
        "sector90": (GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05), 4, 90,
                     float(np.radians(1.0))),
        "invalid_absent": (GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05), 4, 360,
                           None),
        "traced_dphi": (GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05), 4, 360,
                        jnp.float32(2 * np.pi / 360)),
    }[name]
    g = rng.normal(size=(p, spec.rows, spec.cols)).astype(np.float32) * 0.5
    g[:, ::3, ::2] = 0.0
    lo = np.array([spec.position_x, spec.position_y])
    hi = lo + np.array([spec.width, spec.height])
    if name == "edges":
        # the robot at each edge and corner: windows clip at the grid
        mid = (lo + hi) / 2
        xs = [lo[0] + 0.03, hi[0] - 0.03, mid[0], mid[0],
              lo[0] + 0.03, hi[0] - 0.03, lo[0] + 0.03, hi[0] - 0.03]
        ys = [mid[1], mid[1], lo[1] + 0.03, hi[1] - 0.03,
              lo[1] + 0.03, lo[1] + 0.03, hi[1] - 0.03, hi[1] - 0.03]
        xy = np.stack([xs, ys], -1)
    else:
        xy = rng.uniform(lo + 0.2, hi - 0.2, (p, 2))
    theta = rng.uniform(-3.0, 3.0, (p, 1))
    poses = np.concatenate([xy, theta], -1).astype(np.float32)
    dist = rng.uniform(0.05, 1.0, nb).astype(np.float32)
    if name == "invalid_absent":
        valid = rng.random(nb) < 0.4
        present = rng.random(nb) < 0.6
    else:
        valid = rng.random(nb) < 0.85
        present = rng.random(nb) < 0.97
    return (spec, jnp.asarray(g).astype(dtype), jnp.asarray(poses),
            jnp.float32(rng.uniform(-0.3, 0.3)), jnp.asarray(dist),
            jnp.asarray(valid), jnp.asarray(present), nb, dphi)


GEOMETRIES = ["0.05m", "0.02m", "20m", "50m", "edges", "sector90",
              "invalid_absent", "traced_dphi"]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("impl", ["xla", "triton_interpret"])
def test_production_matches_oracle(impl, geometry, dtype):
    """Both production formulations against fused_update_reference:
    per-particle log-likelihood within 1e-4, grids equal up to f32
    rounding except at most 1 in 1e4 window cells (bin flips).  The f32
    bound is looser than bitwise: the division, sqrt and atan2 of two
    separately compiled graphs may round a few ulp apart."""
    spec, g, q, a0, d, v, pr, nb, dphi = _case(geometry, dtype)
    if impl == "xla":
        f = functools.partial(fused_update_xla, dphi=dphi)
    else:
        f = functools.partial(fused_update_triton, dphi=dphi,
                              interpret=True)
    run = jax.jit(lambda *a: f(*a, spec, nb, 1.0))
    g1, l1 = run(g, q, a0, d, v, pr)
    g2, l2 = jax.jit(lambda *a: fused_update_reference(
        *a, spec, nb, 1.0, dphi=dphi))(g, q, a0, d, v, pr)
    assert g1.dtype == g.dtype and g1.shape == g.shape
    flips, n_diff = grid_mismatch(g1, g2)
    cells = window_cells(spec, 1.0, g.shape[0])
    assert flips <= 1e-4 * cells, (flips, n_diff, cells)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), rtol=0,
                               atol=1e-4)
    # the scan changed the map, and nothing outside the windows moved
    changed = np.asarray(g1, np.float32) != np.asarray(g, np.float32)
    assert changed.any()
    r0, c0 = fused.crop_origin(
        (q[:, :2] - jnp.array([spec.position_x, spec.position_y]))
        / spec.resolution, spec, 1.0)
    wr, wc = fused.crop_window(spec, 1.0)
    for i in range(g.shape[0]):
        inside = np.zeros(changed.shape[1:], bool)
        inside[int(r0[i]):int(r0[i]) + wr, int(c0[i]):int(c0[i]) + wc] = 1
        assert not (changed[i] & ~inside).any()


@pytest.mark.parametrize("platform,impl", [
    ("gpu", "triton"), ("cpu", "xla"), ("rocm", None),
    ("metal", None)])
def test_update_impl_platform(platform, impl):
    """One place picks the formulation from the platform; a platform
    without one raises instead of falling back."""
    if impl is None:
        with pytest.raises(ValueError, match="no fused grid update"):
            fused.update_impl(platform)
    else:
        assert fused.update_impl(platform) == impl


@pytest.mark.parametrize("spec,window,blocks", [
    (GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05), (47, 47), (8, 64)),
    (GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.02), (107, 107), (4, 128)),
    (GridSpec2D(-10.0, -10.0, 20.0, 20.0, 0.05), (47, 47), (8, 64)),
    (GridSpec2D(-25.0, -25.0, 50.0, 50.0, 0.05), (47, 47), (8, 64)),
    (GridSpec2D(-1.0, -0.5, 2.0, 1.0, 0.1), (10, 20), (16, 32)),
], ids=["0.05m", "0.02m", "config2", "config3", "clipped"])
def test_crop_window_and_blocks(spec, window, blocks):
    """The disc box per geometry (clipped to small grids) and the
    Triton tile that covers its columns in ~512-cell programs."""
    assert fused.crop_window(spec, 1.0) == window
    assert fused.triton_blocks(*window) == blocks


def test_crop_origin_covers_disc_in_grid():
    """Origins shift the box inside the grid without losing the part of
    the disc that lies in the grid, also for a robot off the map."""
    spec = GridSpec2D(-2.0, -2.0, 4.0, 4.0, 0.05)
    h = fused.disc_half(spec, 1.0)
    wr, wc = fused.crop_window(spec, 1.0)
    cxy = jnp.array([[40.5, 40.5], [0.2, 79.9], [79.9, 0.2], [-5.0, 90.0],
                     [h + 0.5, 80.0 - h - 0.5]], jnp.float32)
    r0, c0 = map(np.asarray, fused.crop_origin(cxy, spec, 1.0))
    assert (r0 >= 0).all() and (r0 + wr <= spec.rows).all()
    assert (c0 >= 0).all() and (c0 + wc <= spec.cols).all()
    for (cx, cy), rr, cc in zip(np.asarray(cxy), r0, c0):
        lo_r = max(int(np.floor(cy)) - h, 0)
        hi_r = min(int(np.floor(cy)) + h, spec.rows - 1)
        lo_c = max(int(np.floor(cx)) - h, 0)
        hi_c = min(int(np.floor(cx)) + h, spec.cols - 1)
        if lo_r <= hi_r:
            assert rr <= lo_r and hi_r < rr + wr
        if lo_c <= hi_c:
            assert cc <= lo_c and hi_c < cc + wc


def test_round_half_even_matches_jnp_round():
    x = jnp.asarray(np.concatenate([
        np.arange(-8, 8, 0.25), np.random.default_rng(0).uniform(
            -400, 400, 1000)]).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(fused._round_half_even(x)),
                                  np.asarray(jnp.round(x)))
