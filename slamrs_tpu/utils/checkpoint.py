"""Checkpoint / resume for rollout state.

The reference has NO persistence — map save/load is an explicitly
unimplemented future direction (slamrs README.md:45) and the config
editor's Apply discards all node state (app.rs:121-134).  A production
framework needs both, so this module adds them as a framework
capability (SURVEY §5.4):

* ``save(path, state)`` / ``load(path, like)``: any pytree of arrays
  (``WorldState``, ``GridSlamState``, ...) round-trips through one
  ``.npz`` file; ``load`` restores onto the template's treedef, dtypes
  and shardings (so a fleet checkpoint resumes onto the same mesh).
* CLI: ``python -m slamrs_tpu rollout ... --save-state s.npz`` /
  ``--resume s.npz``.
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np

_SEP = "|"


def save(path: str, state: Any) -> None:
    """Serialize a pytree of arrays to ``path`` (.npz).

    bfloat16 leaves are stored widened to float32 (exact; npz has no
    bf16 dtype) — ``load`` casts back to the template's dtype, which is
    a lossless round trip."""
    import jax.numpy as jnp

    leaves, treedef = jax.tree.flatten(state)

    def to_np(leaf):
        if hasattr(leaf, "dtype") and leaf.dtype == jnp.bfloat16:
            leaf = leaf.astype(jnp.float32)
        return np.asarray(leaf)

    arrays = {f"leaf_{i}": to_np(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        str(treedef).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load(path: str, like: Any) -> Any:
    """Restore a pytree saved by :func:`save` onto the structure, dtypes
    and device placement of ``like`` (build it with the same config)."""
    import jax.numpy as jnp

    import warnings

    with np.load(path) as data:
        like_leaves, treedef = jax.tree.flatten(like)
        if "__treedef__" in data.files:
            # the str(treedef) repr is NOT a stable serialization (it
            # changes across jax versions / field renames), so a textual
            # mismatch alone must not refuse an otherwise-consistent
            # checkpoint — the leaf-count/shape checks below are the
            # hard gate; this is the loud hint for config mix-ups
            saved_td = bytes(data["__treedef__"]).decode()
            if saved_td != str(treedef):
                warnings.warn(
                    "checkpoint pytree structure repr differs from the "
                    f"template's — saved:\n  {saved_td}\nexpected:\n  "
                    f"{treedef}\n(different config, or a jax/treedef "
                    "repr change; proceeding on leaf shape checks)",
                    stacklevel=2)
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        if n != len(like_leaves):
            raise ValueError(
                f"checkpoint has {n} leaves, template has "
                f"{len(like_leaves)} — config mismatch")
        out = []
        for i, tmpl in enumerate(like_leaves):
            arr = data[f"leaf_{i}"]
            if hasattr(tmpl, "shape") and tuple(arr.shape) != tuple(
                    tmpl.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {arr.shape} != template "
                    f"{tmpl.shape}")
            if hasattr(tmpl, "dtype"):
                tgt = jnp.dtype(tmpl.dtype)
                # bf16 leaves are saved widened to f32 (lossless round
                # trip) — any OTHER narrowing cast is a config smell
                if (np.dtype(arr.dtype).itemsize > tgt.itemsize
                        and not (arr.dtype == np.float32
                                 and tgt == jnp.bfloat16)):
                    warnings.warn(
                        f"checkpoint leaf {i}: narrowing {arr.dtype} -> "
                        f"{tgt} on load (template dtype differs from the "
                        "saved state)", stacklevel=2)
                leaf = jnp.asarray(arr, tmpl.dtype)
                if hasattr(tmpl, "sharding") and hasattr(
                        tmpl.sharding, "mesh"):
                    leaf = jax.device_put(leaf, tmpl.sharding)
            else:
                leaf = arr
            out.append(leaf)
    return jax.tree.unflatten(treedef, out)
