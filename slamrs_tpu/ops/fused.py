"""Fused RBPF grid-SLAM update: likelihood + scan integration per particle.

Reference semantics: ``GridMapSlam::update`` (slamrs/slam/src/grid/
slam.rs:45-75) — per particle, weight by ``Map::probability_of``
(map.rs:113-145) and integrate the scan with ``Map::integrate`` +
``inverse_sensor_model`` (map.rs:71-106, 148-172).

Integration is a dense cell pass over a window around each particle: per
cell, the polar coordinates (r, phi) relative to the particle pose pick
the covering beam (phi -> angular bin -> one lookup in the beam table)
and the inverse sensor model yields the log-odds increment,
multiplicity-compensated near the robot exactly like
``ops.grid.grid_integrate_dense``.  Every cell outside the window is
untouched.  The measurement likelihood is the reference's exact per-beam
endpoint product, gathered from the pre-update map.

Three formulations share that per-cell arithmetic:

* :func:`fused_update_reference` — the oracle the tests compare with:
  per-particle full-width row windows through ``dynamic_slice`` /
  ``dynamic_update_slice`` under ``vmap``.
* :func:`fused_update_xla` — the plain production version: windows
  cropped to the scan disc's bounding box in rows and columns
  (:func:`crop_window`), which XLA compiles to one gather, one fused
  elementwise pass and one scatter.
* :func:`fused_update_triton` — the cell pass as one Pallas kernel
  through Triton: each program reads a power-of-two tile of its
  particle's window with masked loads and writes it back in place.

:func:`fused_update` picks one of them from the platform
(:func:`update_impl`).

Assumes the scan is a uniform angular table starting at ``angles0`` with
spacing ``dphi`` (true for both producers: the simulator and the Neato
frames emit 1-degree tables; non-uniform tables are NOT detected).
``dphi`` is honored exactly — a partial-sector table (e.g. 90 beams x 1
degree) masks cells outside the swept sector instead of wrapping them
onto wrong beams.

Documented deviation: integration covers the scan disc (``max_range_m``
plus the ISM margin), so a beam measured beyond ``max_range_m`` (never
produced by the simulator, possible in replayed real captures) marks
free space only up to the window edge.

Beam-table encoding, row 0: ``d_enc = +d_cells`` (valid hit),
``-d_cells`` (present, invalid) and ``-0.0`` (absent / padding), so one
lookup recovers distance and both flags (map.rs treats invalid beams as
free-space up to the measured distance; absent beams are no-ops).
"""

from __future__ import annotations

import functools
import math as pymath

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from slamrs_tpu.ops.grid import (ADDITIONAL_STEPS, GridSpec2D, L_FREE,
                                 L_OCCUPIED, SENSOR_MAXDIST, TOLERANCE_CELLS,
                                 Z_HIT)

Array = jnp.ndarray

_TWO_PI = 2.0 * pymath.pi


def update_impl(platform: str) -> str:
    """The fused-update formulation for a JAX platform name: the one
    place the choice is made.  ``"gpu"`` runs the Triton kernel,
    ``"cpu"`` the plain XLA version (the tests' path); any other
    platform raises."""
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no fused grid update for platform {platform!r}")


# ---- geometry ---------------------------------------------------------


def disc_half(spec: GridSpec2D, max_range_m: float) -> int:
    """Half-width (cells) of the box around the robot's cell that holds
    every cell a beam of length <= ``max_range_m`` can touch (the
    occupied band ends one cell past the endpoint; +1 cell of margin)."""
    return (int(pymath.ceil(max_range_m / spec.resolution))
            + ADDITIONAL_STEPS + 1)


def window_rows(spec: GridSpec2D, max_range_m: float) -> int:
    """Row count of the reference's full-width windows: the scan disc
    plus slack for the 8-aligned window start."""
    disc = 2 * disc_half(spec, max_range_m) + 1
    wr = ((disc + 8) + 7) // 8 * 8
    return min(wr, (spec.rows + 7) // 8 * 8)


def crop_window(spec: GridSpec2D, max_range_m: float) -> tuple[int, int]:
    """(rows, cols) of the production window: the scan disc's bounding
    box, clipped to the grid."""
    w = 2 * disc_half(spec, max_range_m) + 1
    return min(w, spec.rows), min(w, spec.cols)


def crop_origin(cxy: Array, spec: GridSpec2D, max_range_m: float):
    """Per-particle window origin (r0, c0), i32 [P]: the disc box around
    the robot's cell, shifted inside the grid.  A shifted box still holds
    the part of the disc that lies in the grid."""
    wr, wc = crop_window(spec, max_range_m)
    h = disc_half(spec, max_range_m)
    r0 = jnp.clip(jnp.floor(cxy[:, 1]).astype(jnp.int32) - h, 0,
                  spec.rows - wr)
    c0 = jnp.clip(jnp.floor(cxy[:, 0]).astype(jnp.int32) - h, 0,
                  spec.cols - wc)
    return r0, c0


def static_dphi(dphi) -> float | None:
    """The beam spacing as a Python float when the caller gave a static
    one, else None (a traced table spacing: the generic bin pipeline)."""
    if isinstance(dphi, (int, float)):
        return float(dphi)
    return None


def table_len(num_beams: int, binu: float | None) -> int:
    """Beam-table length: every beam plus the absent slots that bin
    indices can reach.  The traced pipeline maps out-of-sector bins to
    index ``num_beams``; the static pipeline's bins span [0, 2*pi/dphi]."""
    if binu is None:
        return num_beams + 1
    return max(num_beams, int(pymath.ceil(_TWO_PI / binu))) + 1


def encode_beam_table(distances_cells: Array, valid: Array,
                      present: Array, angles0: Array | None = None,
                      dphi: Array | None = None,
                      length: int | None = None) -> Array:
    """[B] beam lanes -> [5, length] f32 table (``length`` defaults to
    B + 1; lanes past B are absent).

    Row 0: ``d_enc`` (signed/zero encoding, module docstring) for the
    inverse-sensor-model bin lookup.  When ``angles0``/``dphi`` are
    given, rows 1-4 carry the endpoint-likelihood lanes (map.rs:117-123
    — only valid beams participate):
      row 1: distance in cells for valid beams, 0 otherwise;
      row 2: cos(angles0 + b * dphi);
      row 3: sin(angles0 + b * dphi);
      row 4: use flag (valid & present).
    """
    b = distances_cells.shape[-1]
    n = b + 1 if length is None else length
    d = jnp.abs(distances_cells)
    enc = jnp.where(valid, d, -d)
    enc = jnp.where(present, enc, jnp.float32(-0.0))
    enc = jnp.where(valid & present & (d == 0.0), jnp.float32(1e-6), enc)
    pad = jnp.full((n - b,), -0.0, jnp.float32)
    row = jnp.concatenate([enc.astype(jnp.float32), pad])
    if angles0 is None:
        return jnp.broadcast_to(row[None, :], (5, n))
    lane = jnp.arange(n, dtype=jnp.float32)
    ang = angles0 + lane * dphi
    use = jnp.zeros((n,), bool).at[:b].set(valid & present)
    d_lik = jnp.where(use, jnp.zeros((n,), jnp.float32).at[:b].set(
        d.astype(jnp.float32)), 0.0)
    ca = jnp.where(use, jnp.cos(ang), 0.0)
    sa = jnp.where(use, jnp.sin(ang), 0.0)
    return jnp.stack([row, d_lik, ca, sa, use.astype(jnp.float32)])


# ---- the per-cell pass (production formulations) -----------------------


def _round_half_even(x: Array) -> Array:
    """``jnp.round`` from floor and compares (Triton has no round op);
    exact for |x| < 2**22."""
    f = jnp.floor(x)
    frac = x - f
    odd = (f - 2.0 * jnp.floor(f * 0.5)) != 0.0
    up = (frac > 0.5) | ((frac == 0.5) & odd)
    return jnp.where(up, f + 1.0, f)


def _cell_pass(win, rowf, colf, cx, cy, t, dphi, inv_dphi, lookup, *,
               num_beams, binu, div=jnp.divide, sqrt=jnp.sqrt):
    """Updated window values (f32) of cells at absolute grid coordinates
    ``rowf``/``colf``; ``win`` holds their pre-update log-odds (f32).

    ``t`` is ``(theta + angles0)/dphi - 0.5`` on the static pipeline
    (``binu`` = the static spacing) and ``theta + angles0`` on the traced
    one.  ``lookup`` maps bin indices to beam-table row 0.  The per-cell
    model of :func:`fused_update_reference` (which folds the row offset
    in another order); ``div`` and ``sqrt`` let the Triton kernel ask
    for IEEE-rounded instructions.
    """
    dx = colf + (0.5 - cx)
    dy = rowf + (0.5 - cy)
    r2 = dx * dx + dy * dy
    r = sqrt(r2)
    phi = jnp.arctan2(dy, dx)
    if binu is not None:
        inv_s = jnp.float32(1.0 / binu)
        nbf = _TWO_PI / binu
        b0 = phi * inv_s - t
        b0 = b0 - nbf * jnp.floor(b0 * (1.0 / nbf))
        bins = jnp.floor(b0).astype(jnp.int32)
    else:
        nb_f = _TWO_PI * inv_dphi
        b0 = phi * inv_dphi - t * inv_dphi
        b0 = b0 - nb_f * jnp.floor(b0 * (dphi * (1.0 / _TWO_PI)))
        bins_f = _round_half_even(b0)
        wrap = bins_f >= nb_f - 0.5
        absent = (bins_f > num_beams - 1) & (~wrap)
        bins_f = jnp.where(wrap, 0.0, bins_f)
        bins_f = jnp.where(absent, float(num_beams), bins_f)
        bins = bins_f.astype(jnp.int32)
    d_enc = lookup(bins)
    was_hit = d_enc > 0.0
    pres = d_enc != 0.0  # +-0.0 -> absent (IEEE: -0.0 == 0.0)
    d = jnp.abs(d_enc)
    half = TOLERANCE_CELLS / 2.0
    dm = jnp.maximum(d - half, 0.0)
    a_sq = jnp.where(was_hit, dm * dm, d * d)
    dp = d + half
    b_sq = jnp.where(was_hit, dp * dp, -1.0)
    inc = jnp.where(r2 < a_sq, L_FREE,
                    jnp.where(r2 <= b_sq, L_OCCUPIED, 0.0))
    # multiplicity compensation: beams-per-cell density near the robot
    dens = jnp.maximum(1.0, div(jnp.ones_like(r), jnp.maximum(r, 0.5)
                                * dphi))
    inc = jnp.where(pres, inc * dens, 0.0)
    # no log-odds clamp: unbounded growth matches the reference (see the
    # ops.grid LOGODDS_CLAMP note)
    return win + inc


def _endpoint_log_lik(grids: Array, cxy: Array, theta: Array,
                      table: Array, spec: GridSpec2D,
                      num_beams: int) -> Array:
    """Exact per-beam endpoint likelihood (map.rs:113-145) -> f32 [P],
    one [P, B] gather from the pre-update maps.  Endpoints outside the
    grid are skipped, as the reference's ``is_valid`` check does."""
    p = grids.shape[0]
    d_b = table[1, :num_beams]
    ca = table[2, :num_beams]
    sa = table[3, :num_beams]
    use = table[4, :num_beams] > 0.5
    ct = jnp.cos(theta)[:, None]
    st = jnp.sin(theta)[:, None]
    cx = cxy[:, 0:1]
    cy = cxy[:, 1:2]
    ex = cx + (ct * ca - st * sa) * d_b
    ey = cy + (st * ca + ct * sa) * d_b
    use = use & ((ex >= 0.0) & (ey >= 0.0) & (ex < float(spec.cols))
                 & (ey < float(spec.rows)))
    xi = jnp.where(use, jnp.floor(ex).astype(jnp.int32), 0)
    yi = jnp.where(use, jnp.floor(ey).astype(jnp.int32), 0)
    odds = grids[jnp.arange(p)[:, None], yi, xi].astype(jnp.float32)
    p_end = 1.0 - 1.0 / (1.0 + jnp.exp(odds))
    mix = Z_HIT * p_end + (1.0 - Z_HIT) / SENSOR_MAXDIST
    factor = jnp.where(odds == 0.0, 1.0 / SENSOR_MAXDIST, mix)
    return jnp.sum(jnp.where(use, jnp.log(factor), 0.0), axis=-1)


def _prepare(grids, poses, angles0, distances, valid, present, spec,
             num_beams, max_range_m, dphi):
    """Shared set-up of the production formulations: grid-unit poses,
    the beam table, per-particle scalars [P, 8] (cx, cy, t, dphi,
    1/dphi, then zeros up to a power-of-two row for the kernel's block),
    window origins and the likelihood."""
    p = grids.shape[0]
    if dphi is None:
        dphi = _TWO_PI / num_beams
    binu = static_dphi(dphi)
    dphi = jnp.asarray(dphi, jnp.float32)
    pos = jnp.array([spec.position_x, spec.position_y], jnp.float32)
    cxy = (poses[:, 0:2] - pos) / spec.resolution
    theta = poses[:, 2]
    table = encode_beam_table(distances / spec.resolution, valid, present,
                              angles0, dphi,
                              length=table_len(num_beams, binu))
    t = theta + angles0
    if binu is not None:
        t = t * jnp.float32(1.0 / binu) - 0.5
    inv_dphi = 1.0 / dphi
    zero = jnp.zeros((p,), jnp.float32)
    par = jnp.stack([cxy[:, 0], cxy[:, 1], t,
                     jnp.broadcast_to(dphi, (p,)),
                     jnp.broadcast_to(inv_dphi, (p,)), zero, zero, zero],
                    axis=-1)
    r0, c0 = crop_origin(cxy, spec, max_range_m)
    lik = _endpoint_log_lik(grids, cxy, theta, table, spec, num_beams)
    return binu, table, par, r0, c0, lik


def fused_update_xla(grids: Array, poses: Array, angles0: Array,
                     distances: Array, valid: Array, present: Array,
                     spec: GridSpec2D, num_beams: int, max_range_m: float,
                     dphi=None):
    """Plain production update: per particle, the disc-box window is
    sliced, passed through :func:`_cell_pass` and written back.

    Args:
      grids: [P, H, W] log-odds (f32 or bf16), W >= spec.cols (cells
        past the logical grid are never touched).
      poses: [P, 3] world poses (sampled successor poses).
      angles0: scalar first-beam angle; distances/valid/present: [B].
      dphi: beam spacing in radians — a Python float selects the static
        bin pipeline; default 2*pi/num_beams.
    Returns:
      (grids', log_lik [P]).
    """
    binu, table, par, r0, c0, lik = _prepare(
        grids, poses, angles0, distances, valid, present, spec, num_beams,
        max_range_m, dphi)
    wr, wc = crop_window(spec, max_range_m)
    row0 = table[0]
    rloc = jnp.arange(wr, dtype=jnp.int32)[:, None]
    cloc = jnp.arange(wc, dtype=jnp.int32)[None, :]

    def one(grid, pp, rr0, cc0):
        win = jax.lax.dynamic_slice(grid, (rr0, cc0), (wr, wc)).astype(
            jnp.float32)
        new = _cell_pass(win, (rr0 + rloc).astype(jnp.float32),
                         (cc0 + cloc).astype(jnp.float32), pp[0], pp[1],
                         pp[2], pp[3], pp[4], lambda b: row0[b],
                         num_beams=num_beams, binu=binu)
        return jax.lax.dynamic_update_slice(grid, new.astype(grid.dtype),
                                            (rr0, cc0))

    return jax.vmap(one)(grids, par, r0, c0), lik


# ---- the cell pass as a Pallas kernel through Triton -------------------


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


# cells per program and warps per program: 512 cells on 4 warps measured
# fastest of 512-4096 cells x 2/4/8 warps at the headline geometry
# (H100 80GB HBM3 at 700 W)
_TILE_CELLS = 512
_NUM_WARPS = 4


def triton_blocks(wr: int, wc: int) -> tuple[int, int]:
    """(rows, cols) of one program's tile: the window's columns rounded
    up to a power of two, and as many rows as make ``_TILE_CELLS`` cells
    (Triton blocks are powers of two; masked loads cover the rest)."""
    bc = _next_pow2(wc)
    br = max(1, min(_next_pow2(wr), _TILE_CELLS // bc))
    return br, bc


def _div_rn(a, b):
    return plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;", args=[a, b], constraints="=f,f,f",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape,
                                                          jnp.float32)])[0]


def _sqrt_rn(a):
    return plgpu.elementwise_inline_asm(
        "sqrt.rn.f32 $0, $1;", args=[a], constraints="=f,f", pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape, jnp.float32)])[0]


def _cell_kernel(org_ref, par_ref, tab_ref, g_ref, o_ref, *, br, bc, wr,
                 wc, num_beams, binu, ieee_asm):
    """One program: rows [k*br, (k+1)*br) x cols [0, bc) of one
    particle's window, masked to the window, updated in place."""
    k = pl.program_id(1)
    r0 = org_ref[0]
    c0 = org_ref[1]
    rloc = k * br + jax.lax.broadcasted_iota(jnp.int32, (br, bc), 0)
    cloc = jax.lax.broadcasted_iota(jnp.int32, (br, bc), 1)
    mask = (rloc < wr) & (cloc < wc)
    view = (pl.ds(r0 + k * br, br), pl.ds(c0, bc))
    win = plgpu.load(g_ref.at[view], mask=mask, other=0.0).astype(
        jnp.float32)
    new = _cell_pass(
        win, (r0 + rloc).astype(jnp.float32),
        (c0 + cloc).astype(jnp.float32), par_ref[0], par_ref[1],
        par_ref[2], par_ref[3], par_ref[4], lambda b: tab_ref[b],
        num_beams=num_beams, binu=binu,
        div=_div_rn if ieee_asm else jnp.divide,
        sqrt=_sqrt_rn if ieee_asm else jnp.sqrt)
    plgpu.store(o_ref.at[view], new.astype(o_ref.dtype), mask=mask)


def fused_update_triton(grids: Array, poses: Array, angles0: Array,
                        distances: Array, valid: Array, present: Array,
                        spec: GridSpec2D, num_beams: int,
                        max_range_m: float, dphi=None,
                        interpret: bool = False):
    """:func:`fused_update_xla` with the cell pass as one Pallas kernel
    through Triton, grid ``(P, row_chunks)``.  Each program loads its
    particle's window origin and scalars itself, reads a power-of-two
    tile of the window with masked loads, looks the bins up in the beam
    table by index, and stores in place (``input_output_aliases``).  The
    likelihood gather runs before the kernel, so no program reads a
    cell another program has written.  ``interpret=True`` runs it on
    the CPU (the kernel's IEEE division/sqrt instructions are then the
    plain ops, which round the same way)."""
    binu, table, par, r0, c0, lik = _prepare(
        grids, poses, angles0, distances, valid, present, spec, num_beams,
        max_range_m, dphi)
    p, rows, cols = grids.shape
    wr, wc = crop_window(spec, max_range_m)
    br, bc = triton_blocks(wr, wc)
    org = jnp.stack([r0, c0], axis=-1)
    kernel = functools.partial(_cell_kernel, br=br, bc=bc, wr=wr, wc=wc,
                               num_beams=num_beams, binu=binu,
                               ieee_asm=not interpret)
    grid_spec = pl.BlockSpec((None, rows, cols), lambda i, k: (i, 0, 0))
    out = pl.pallas_call(
        kernel,
        grid=(p, pl.cdiv(wr, br)),
        in_specs=[
            pl.BlockSpec((None, 2), lambda i, k: (i, 0)),
            pl.BlockSpec((None, 8), lambda i, k: (i, 0)),
            pl.BlockSpec((table.shape[1],), lambda i, k: (0,)),
            grid_spec,
        ],
        out_specs=grid_spec,
        out_shape=jax.ShapeDtypeStruct(grids.shape, grids.dtype),
        input_output_aliases={3: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="fused_cell_pass",
    )(org, par, table[0], grids)
    return out, lik


def fused_update(grids: Array, poses: Array, angles0: Array,
                 distances: Array, valid: Array, present: Array,
                 spec: GridSpec2D, num_beams: int, max_range_m: float,
                 dphi=None):
    """One RBPF grid update for all particles, in the formulation
    :func:`update_impl` picks for the default backend.  Same contract
    as :func:`fused_update_xla`."""
    args = (grids, poses, angles0, distances, valid, present, spec,
            num_beams, max_range_m, dphi)
    if update_impl(jax.default_backend()) == "triton":
        return fused_update_triton(*args)
    return fused_update_xla(*args)


# ---- the oracle ---------------------------------


def fused_update_reference(grids, poses, angles0, distances, valid, present,
                           spec: GridSpec2D, num_beams: int,
                           max_range_m: float, dphi=None):
    """Pure-jnp oracle (for tests): full-width row windows, 8-aligned,
    and a 512-lane beam table (absent past the beams)."""
    p, rows, cols = grids.shape
    wr = window_rows(spec, max_range_m)
    wr = min(wr, rows - rows % 8 if rows % 8 else rows)
    pos = jnp.array([spec.position_x, spec.position_y], jnp.float32)
    cxy = (poses[:, 0:2] - pos) / spec.resolution
    r0 = jnp.round(cxy[:, 1]).astype(jnp.int32) - wr // 2
    r0 = jnp.clip(r0, 0, max(rows - wr, 0))
    r0 = (r0 // 8) * 8
    if dphi is None:
        dphi = 2.0 * pymath.pi / num_beams
    binu = static_dphi(dphi)
    dphi = jnp.asarray(dphi, jnp.float32)
    table = encode_beam_table(distances / spec.resolution, valid, present,
                              angles0, dphi, length=max(512, num_beams + 1))
    half = TOLERANCE_CELLS / 2.0
    two_pi = 2.0 * pymath.pi

    def one(grid, cx, cy, theta, rr0):
        win = jax.lax.dynamic_slice(grid, (rr0, 0), (wr, cols)).astype(
            jnp.float32)

        # exact endpoint likelihood on the pre-update window
        d_b = table[1]
        ca = table[2]
        sa = table[3]
        use = table[4] > 0.5
        ct, st = jnp.cos(theta), jnp.sin(theta)
        ex = cx + (ct * ca - st * sa) * d_b
        ey = cy + (st * ca + ct * sa) * d_b
        in_b_beam = ((ex >= 0.0) & (ey >= 0.0) & (ex < float(spec.cols))
                     & (ey < float(spec.rows)))
        use = use & in_b_beam
        xi = jnp.floor(ex).astype(jnp.int32)
        yi = jnp.floor(ey).astype(jnp.int32) - rr0
        use = use & (yi >= 0) & (yi < wr) & (xi >= 0) & (xi < cols)
        xi = jnp.where(use, xi, 0)
        yi = jnp.where(use, yi, 0)
        odds = win[yi, xi]
        p_end = 1.0 - 1.0 / (1.0 + jnp.exp(odds))
        mix = Z_HIT * p_end + (1.0 - Z_HIT) / SENSOR_MAXDIST
        factor = jnp.where(odds == 0.0, 1.0 / SENSOR_MAXDIST, mix)
        lik = jnp.sum(jnp.where(use, jnp.log(factor), 0.0))

        # folded-offset arithmetic (rounds a few ulp apart from the
        # production _cell_pass; the parity bounds absorb it)
        wyl = jnp.arange(wr, dtype=jnp.float32)[:, None]
        wxl = jnp.arange(cols, dtype=jnp.float32)[None, :]
        rr0f = rr0.astype(jnp.float32)
        dx = wxl + (0.5 - cx)
        dy = wyl + (rr0f + (0.5 - cy))
        r2 = dx * dx + dy * dy
        r = jnp.sqrt(r2)
        phi = jnp.arctan2(dy, dx)
        if binu is not None:
            # static bin units: floor-form rounding constant T, the wrap
            # bounds bins to [0, 2*pi/dphi] — absent slots past the beams
            inv_s = jnp.float32(1.0 / binu)
            nbf = two_pi / binu
            t_const = (theta + angles0) * inv_s - 0.5
            b0 = phi * inv_s - t_const
            b0 = b0 - nbf * jnp.floor(b0 * (1.0 / nbf))
            bins = jnp.floor(b0).astype(jnp.int32)
        else:
            inv_dphi = 1.0 / dphi
            ta = theta + angles0
            nb_f = two_pi * inv_dphi
            b0 = phi * inv_dphi - ta * inv_dphi
            b0 = b0 - nb_f * jnp.floor(b0 * (dphi * (1.0 / two_pi)))
            bins_f = jnp.round(b0)
            wrap = bins_f >= nb_f - 0.5
            absent = (bins_f > num_beams - 1) & (~wrap)
            bins_f = jnp.where(wrap, 0.0, bins_f)
            bins_f = jnp.where(absent, float(num_beams), bins_f)
            bins = bins_f.astype(jnp.int32)
        d_enc = table[0][bins]
        was_hit = d_enc > 0.0
        pres = d_enc != 0.0
        d = jnp.abs(d_enc)
        dm = jnp.maximum(d - half, 0.0)
        a_sq = jnp.where(was_hit, dm * dm, d * d)
        dp = d + half
        b_sq = jnp.where(was_hit, dp * dp, -1.0)
        inc = jnp.where(r2 < a_sq, L_FREE,
                        jnp.where(r2 <= b_sq, L_OCCUPIED, 0.0))
        dens = jnp.maximum(1.0, 1.0 / (jnp.maximum(r, 0.5) * dphi))
        in_b = ((wyl < float(spec.rows) - rr0f)
                & (wxl < float(spec.cols)))
        inc = jnp.where(pres & in_b, inc * dens, 0.0)
        out = jax.lax.dynamic_update_slice(
            grid, (win + inc).astype(grid.dtype), (rr0, 0))
        return out, lik

    grids_out, lik = jax.vmap(one)(grids, cxy[:, 0], cxy[:, 1],
                                   poses[:, 2], r0)
    return grids_out, lik
