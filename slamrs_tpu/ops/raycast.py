"""Batched ray ↔ line-segment raycasting.

Parity surface: ``slamrs/simulator/src/scene/ray.rs`` —
``LineSegment::intersect`` (ray.rs:56-83, the two-line closed form with
parameters ``t`` on the segment and ``u`` along the ray) and
``Scene::intersect`` (ray.rs:164-172, min-``u`` over all objects).

Design: the reference walks 360 beams in a Python-style loop and,
per beam, a boxed-trait loop over scene objects (O(beams × segments) scalar
work under an RwLock, sim.rs:134-159).  Here the whole thing is one fused
elementwise computation over a ``[..., B, S]`` broadcast followed by a
min-reduction over S — XLA fuses it into a single kernel, and a
``vmap``/shard over worlds batches it across the fleet.  At 360 beams x
O(100) segments per world the arithmetic is tiny; the win is doing every
world x beam x segment in one launch with zero host involvement.

Scenes are padded arrays: ``segments f32[S, 4]`` rows ``(x1, y1, x2, y2)``
with a validity mask, so scene size is static under jit (rectangles
decompose into 4 segments as in Scene::add_rect, ray.rs:124-149).
"""

from __future__ import annotations

import jax.numpy as jnp

Array = jnp.ndarray

# Sentinel distance for "no intersection"; large but finite so min-reduce
# and subsequent arithmetic stay NaN-free.
NO_HIT: float = 1e30


def segment_intersect(origins: Array, directions: Array, segments: Array,
                      segment_mask: Array | None = None) -> Array:
    """Ray-vs-every-segment intersection parameter.

    Args:
      origins:    f32[..., 2] ray origins.
      directions: f32[..., 2] ray direction unit vectors (need not be unit;
                  ``u`` is in units of the direction length, matching the
                  reference where directions come from cos/sin and are unit).
      segments:   f32[S, 4] rows (x1, y1, x2, y2).
      segment_mask: bool[S] optional validity mask for padded scenes.

    Returns:
      f32[..., S]: intersection parameter ``u`` per segment, ``NO_HIT``
      where the ray misses (t outside [0,1], u <= 0, parallel, or masked).

    Parity: LineSegment::intersect (ray.rs:56-83).  The reference returns
    u for t in [0,1] and u > 0 (strict), None otherwise.
    """
    x1 = segments[..., 0]
    y1 = segments[..., 1]
    x2 = segments[..., 2]
    y2 = segments[..., 3]

    x3 = origins[..., 0:1]
    y3 = origins[..., 1:2]
    dx = directions[..., 0:1]
    dy = directions[..., 1:2]
    # x4 - x3 = dx, y4 - y3 = dy (reference builds x4 = x3 + dx explicitly)

    denom = (x1 - x2) * (-dy) - (y1 - y2) * (-dx)
    safe_denom = jnp.where(denom == 0.0, 1.0, denom)

    t = ((x1 - x3) * (-dy) - (y1 - y3) * (-dx)) / safe_denom
    u = -((x1 - x2) * (y1 - y3) - (y1 - y2) * (x1 - x3)) / safe_denom

    ok = (denom != 0.0) & (t >= 0.0) & (t <= 1.0) & (u > 0.0)
    if segment_mask is not None:
        ok = ok & segment_mask
    return jnp.where(ok, u, NO_HIT)


def raycast(origin: Array, angles: Array, segments: Array,
            segment_mask: Array | None = None) -> tuple[Array, Array]:
    """Closest-hit raycast for a fan of beams from one origin per batch.

    Args:
      origin:  f32[..., 2] sensor origin (one per batch element).
      angles:  f32[..., B] world-frame beam angles.
      segments: f32[S, 4], segment_mask: bool[S].

    Returns:
      (dist f32[..., B], hit bool[..., B]) — min-``u`` over segments
      (Scene::intersect, ray.rs:164-172) and whether any segment was hit.
    """
    directions = jnp.stack([jnp.cos(angles), jnp.sin(angles)], axis=-1)
    # broadcast origin over the beam axis: [..., B, 2]
    o = jnp.broadcast_to(origin[..., None, :], directions.shape)
    u = segment_intersect(o, directions, segments, segment_mask)  # [..., B, S]
    dist = jnp.min(u, axis=-1)
    hit = dist < NO_HIT
    return dist, hit
