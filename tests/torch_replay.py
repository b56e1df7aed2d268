"""Shared helpers of the tests/test_torch_*.py files.

``JaxReplayNoise`` walks the JAX driver's key tree (PMMVS._next_key ->
propagate_round's 4-way split -> generate_hypotheses' jitter and the
gauntlet's per-chunk, per-round refinement draws; or, for a pmvs round,
expand_round's key passed whole to the gauntlet) with ``jax.random`` on
the CPU, and hands the port the same numbers as numpy-backed tensors.
With it, ``mvskit_tpu_torch`` and ``mvskit_tpu`` consume identical
random numbers in a whole run.

``jax_scene_to_torch`` / ``jax_table_to_torch`` carry the JAX package's
state into the port through ``mvskit_tpu_torch.interop``.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from mvskit_tpu_torch import interop

# The test suite runs in several worker processes on one machine, each
# with JAX's own thread pools; torch's OpenMP threads spin while they
# wait, so more than one per process oversubscribes the cores and slows
# every worker many times over. The test sizes gain nothing from them.
torch.set_num_threads(1)


def _gauntlet_draws(key, chunk, n_chunks, rounds, rows, n_cands) -> torch.Tensor:
    """The refinement deltas of chunk `chunk` of a JAX
    _gauntlet_chunked(key): the chunk's key split per round."""
    ck = jax.random.split(key, n_chunks)[chunk]
    keys = jax.random.split(ck, rounds)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(
            keys[r], (rows, n_cands, 3), minval=-1.0, maxval=1.0
        ))
        for r in range(rounds)
    ]))


class _JaxRound:
    """The random numbers of one JAX propagate_round(key)."""

    def __init__(self, key):
        _, self.k1a, self.k1b, self.k2 = jax.random.split(key, 4)

    def jitter(self, axis: int, n: int) -> torch.Tensor:
        k = self.k1a if axis == 0 else self.k1b
        u = jax.random.uniform(k, (n, 2), minval=-0.5, maxval=0.5)
        return torch.from_numpy(np.array(u))

    def refine(self, chunk, n_chunks, rounds, rows, n_cands) -> torch.Tensor:
        return _gauntlet_draws(self.k2, chunk, n_chunks, rounds, rows, n_cands)


class JaxExpandRound:
    """The random numbers of one JAX expand_round(key): the round hands
    its key to _gauntlet_chunked whole (expand.py:229-232), with no
    4-way split."""

    def __init__(self, key):
        self.key = key

    def refine(self, chunk, n_chunks, rounds, rows, n_cands) -> torch.Tensor:
        return _gauntlet_draws(self.key, chunk, n_chunks, rounds, rows, n_cands)


class JaxReplayNoise:
    """Noise source replaying mvskit_tpu.pipeline.driver.PMMVS's keys
    (PRNGKey(seed), one split per propagation or expansion round)."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)

    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def round(self) -> _JaxRound:
        return _JaxRound(self._next_key())

    def expand_round(self) -> JaxExpandRound:
        return JaxExpandRound(self._next_key())


def refine_deltas(key, rounds: int, B: int, n_cands: int) -> np.ndarray:
    """The [rounds, B, n_cands, 3] draws of JAX refine_batch(key)."""
    keys = jax.random.split(key, rounds)
    return np.stack([
        np.asarray(jax.random.uniform(
            keys[r], (B, n_cands, 3), minval=-1.0, maxval=1.0
        ))
        for r in range(rounds)
    ])


def jax_scene_to_torch(scene, P, device="cpu"):
    """The port's Scene for a JAX Scene built from projections P."""
    return interop.scene_from_numpy(
        np.asarray(scene.planes), np.asarray(scene.planes_packed),
        None if scene.masks is None else np.asarray(scene.masks),
        P, scene.offsets, scene.widths, scene.heights, scene.max_level,
        device=device, planes_luma_quad=np.asarray(scene.planes_luma_quad),
    )


def jax_table_to_torch(table, device="cpu"):
    return interop.table_from_numpy(
        {k: np.asarray(getattr(table, k)) for k in interop.TABLE_FIELDS},
        device=device,
    )


def seeded_plane(n_views=6, n_patches=64, capacity=512, extent=0.7, seed=1,
                 floaters=0, level=1, tau=6, wsize=7):
    """A JAX plane scene and a seeded JAX patch table (views by
    add_images + sortImages, scales, NCC), optionally with `floaters`
    patches lifted off the surface; plus the port's copies of both.
    Returns (Ps, jax_scene, jax_table, torch_scene, torch_table)."""
    import jax.numpy as jnp

    from mvskit_tpu.core import patches as pt
    from mvskit_tpu.ops import ncc as nccops
    from mvskit_tpu.pipeline import views as vw
    from mvskit_tpu.utils import synthetic

    a = float(np.deg2rad(60.0))
    Ps, _, scene = synthetic.plane_scene(n_views=n_views, width=160, height=120)
    coord, normal = synthetic.plane_points(Ps, n_patches, seed=seed, extent=extent)
    if floaters:
        rng = np.random.default_rng(seed)
        coord[:floaters, 2] += rng.uniform(0.1, 0.3, floaters)
    c = jnp.asarray(coord, jnp.float32)
    n = jnp.asarray(normal, jnp.float32)
    images = jnp.full((n_patches, n_views), -1, jnp.int32)
    images = vw.add_images(scene, c, n, images, level, a)
    images = vw.sort_images(scene, c, n, images, level, is_fixed=False)
    dscale, ascale = vw.set_scales(scene, c, images, level, tau, wsize)
    ncc = nccops.compute_patch_ncc(scene, images, c, n, level, wsize, tau, a)
    table = pt.from_numpy(
        np.asarray(c), np.asarray(n), np.asarray(images), capacity, n_views,
        ncc=np.asarray(ncc), dscale=np.asarray(dscale),
        ascale=np.asarray(ascale),
    )
    table = table._replace(alive=table.alive & (pt.count_valid(table.images) > 0))
    return Ps, scene, table, jax_scene_to_torch(scene, Ps), jax_table_to_torch(table)
