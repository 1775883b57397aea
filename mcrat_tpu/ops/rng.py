"""Counter-based randomness helpers for batched Monte Carlo sampling.

The reference uses per-rank (and per-OpenMP-thread) GSL ranlxs0 streams
(Src/mclib.c:448-462).  Here all sampling is driven by JAX PRNG keys, split
per round (and per shard on a mesh).

The central utility is :func:`batched_rejection`: the reference's scalar
``while (y > f(x))`` loops (e.g. Src/electron.c:212-223, Src/mcrat_scattering.c:
532-540) become a single ``lax.while_loop`` over the whole batch with a per-lane
acceptance mask — each iteration proposes for every unaccepted lane at once.
"""
from __future__ import annotations

import os
from typing import Callable, Tuple

import jax
import jax.numpy as jnp


def make_key(seed: int, impl: str | None = None) -> jax.Array:
    """Create the PRNG key for the transport hot path.

    Defaults to ``threefry2x32``: on an H100 80GB HBM3 (700 W power limit)
    the headline round body runs ~27 % faster with it than with ``rbg``
    (1.66-1.68 vs 2.27-2.33 ns/photon-round, PERF.md).  The rejection samplers draw O(100) words per
    photon-round, so the choice matters for throughput.
    ``MCRAT_TPU_RNG=rbg`` or the ``impl`` argument selects another
    implementation; every sampler is implementation-agnostic (they only
    split/fold_in/draw).
    """
    impl = impl or os.environ.get("MCRAT_TPU_RNG", "threefry2x32")
    return jax.random.key(seed, impl=impl)


def batched_rejection(
    key: jax.Array,
    shape: Tuple[int, ...],
    propose: Callable[[jax.Array], Tuple],
    accept: Callable[..., jax.Array],
    init: Tuple,
    max_iters: int = 24,
):
    """Vectorized rejection sampling with a *statically unrolled* trial loop.

    Parameters
    ----------
    key: PRNG key.
    shape: batch shape of the sample.
    propose: ``propose(key) -> tuple_of_arrays`` producing candidate draws with
        leading shape ``shape``.
    accept: ``accept(*candidates) -> bool array`` of shape ``shape``.
    init: tuple of fallback arrays (same structure as ``propose`` output) used
        for lanes that never accept within ``max_iters`` (should be a valid,
        physically sane draw).
    max_iters: number of unrolled trials.  Unrolling (instead of a
        ``lax.while_loop``) lets XLA fuse the whole sampler into the round
        body instead of adding a device loop, with its own per-trip overhead,
        per sampler per round.  With per-trial acceptance p the
        residual never-accepted fraction is (1-p)^max_iters — for the KN and
        Maxwell-Juttner samplers (p >~ 0.3) and the default 24 trials this is
        <~ 2e-4 of lanes, which keep the (physically valid) ``init`` draw.

    Returns the tuple of accepted arrays.
    """
    done = jnp.zeros(shape, dtype=bool)
    vals = tuple(init)
    for i in range(max_iters):
        cand = propose(jax.random.fold_in(key, i))
        ok = accept(*cand)
        take = jnp.logical_and(ok, ~done)
        vals = tuple(
            jnp.where(_bcast(take, v.ndim - len(shape)), c, v)
            for c, v in zip(cand, vals)
        )
        done = jnp.logical_or(done, ok)
    return vals


def _bcast(mask, extra_dims: int):
    """Broadcast a ``shape`` mask over trailing vector dims."""
    for _ in range(extra_dims):
        mask = mask[..., None]
    return mask


def uniform_pos(key, shape, dtype):
    """Uniform in (0, 1): strictly positive, like gsl_rng_uniform_pos."""
    u = jax.random.uniform(key, shape, dtype=dtype)
    return jnp.maximum(u, jnp.finfo(dtype).tiny)


def isotropic_direction(key, shape, dtype):
    """Isotropic unit vectors: cos(theta) uniform in [-1, 1], phi uniform.

    Matches the injection sampling (reference: Src/mclib.c:225-233).
    Returns (n, 3).
    """
    k1, k2 = jax.random.split(key)
    cos_t = jax.random.uniform(key=k1, shape=shape, dtype=dtype, minval=-1.0, maxval=1.0)
    phi = jax.random.uniform(key=k2, shape=shape, dtype=dtype, minval=0.0, maxval=2.0 * jnp.pi)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)
