"""Parallel random number generation.

Primary generator: the **Squares** counter-based RNG (Widynski 2022),
reimplemented bit-exactly from the reference ``module_rng``
(/root/reference/src/mptrac.c:5598-5667, RNG_TYPE 1) so that
trajectories can be cross-checked against reference runs: same key,
same counter advance (n+1 per call), same Box–Muller pairing with the
reference's single-precision cos/sin quirk.

Counter-based RNG is the natural accelerator fit: stateless,
order-independent within a batch, and vectorizes to pure integer ALU
work.  ``jax.random``
(threefry) is offered as RNG_TYPE 2 for idiomatic use (the reference's
type 2 is cuRAND, which has no bitwise-defined stream either).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

#: Squares key (reference mptrac.c:5601 — fixed, do not change)
SQUARES_KEY = 0xC8E4FD154CE32F6D


def _squares(counters):
    """Squares output bits for a uint64 counter array, as (hi, lo)
    uint32 (reference c:5598-5630)."""
    key = jnp.uint64(SQUARES_KEY)
    x = counters * key
    y = x
    z = y + key

    def sqr_round(x, add):
        x = x * x + add
        return (x >> jnp.uint64(32)) | (x << jnp.uint64(32))

    x = sqr_round(x, y)
    x = sqr_round(x, z)
    x = sqr_round(x, y)
    t = x * x + z
    x = (t >> jnp.uint64(32)) | (t << jnp.uint64(32))
    r = t ^ ((x * x + y) >> jnp.uint64(32))
    hi = (r >> jnp.uint64(32)).astype(jnp.uint32)
    lo = (r & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    return hi, lo


def squares_bits(ctr, n: int):
    """Raw Squares bits for counters ctr..ctr+n as (hi, lo) u32
    arrays; identical on every backend (reference c:5598-5630)."""
    return _squares(ctr + jnp.arange(n + 1, dtype=jnp.uint64))


def squares_uniform(ctr, n: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Generate ``n + 1`` uniform doubles in [0, 1) and the advanced
    counter (reference c:5598-5630: the loop runs ``i <= n`` and the
    counter advances by ``n + 1``)."""
    hi32, lo32 = squares_bits(ctr, n)
    # Correctly-rounded uint64 -> double (XLA's direct cast can round
    # differently from C): hi*2^32 is exact, the sum rounds to nearest.
    # Scaling by the exact power of two 2^-64 gives the same bits as
    # dividing by 2^64.
    hi = hi32.astype(jnp.float64)
    lo = lo32.astype(jnp.float64)
    u = (hi * 4294967296.0 + lo) * (0.5 ** 64)
    return u, ctr + jnp.uint64(n + 1)


def squares_normal(ctr, n: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Generate ``n`` standard-normal doubles via the reference's
    Box–Muller transform (c:5632-5648): pairs (r cos phi, r sin phi)
    with phi evaluated in single precision (the reference calls
    ``cosf((float) phi)``)."""
    u, ctr = squares_uniform(ctr, n)
    m = (n + 1) // 2
    evens = u[0:n:2]
    odds = u[1:n + 1:2]
    r = jnp.sqrt(-2.0 * jnp.log(evens))
    phi = 2.0 * jnp.pi * odds
    phif = phi.astype(jnp.float32)
    out_e = r * jnp.cos(phif).astype(jnp.float64)
    out_o = r * jnp.sin(phif).astype(jnp.float64)
    out = jnp.stack([out_e[:m], out_o[:m]], axis=1).reshape(-1)[:n]
    return out, ctr


def squares_uniform_f32(ctr, n: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """float32 uniforms from the same Squares bit stream (fp32 compute
    mode): the top 24 bits of each 64-bit draw, scaled by 2^-24.  Same
    counter advance as squares_uniform, so stream positions stay
    aligned with the f64 parity path; values are the f64 path's
    round-to-24-bit truncations.  Avoids all f64 arithmetic."""
    hi32, _ = squares_bits(ctr, n)
    u = (hi32 >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(0.5 ** 24)
    return u, ctr + jnp.uint64(n + 1)


def squares_normal_f32(ctr, n: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """float32 Box-Muller normals over the f32 uniform stream (fp32
    compute mode; same pairing as squares_normal)."""
    u, ctr = squares_uniform_f32(ctr, n)
    m = (n + 1) // 2
    evens = jnp.maximum(u[0:n:2], jnp.float32(0.5 ** 25))
    odds = u[1:n + 1:2]
    r = jnp.sqrt(jnp.float32(-2.0) * jnp.log(evens))
    phi = jnp.float32(2.0 * 3.141592653589793) * odds
    out_e = r * jnp.cos(phi)
    out_o = r * jnp.sin(phi)
    out = jnp.stack([out_e[:m], out_o[:m]], axis=1).reshape(-1)[:n]
    return out, ctr


def squares_normal3_f32(ctr, n: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Three component-major float32 normal streams from the Squares
    counter (fp32 compute mode).

    The reference stream (squares_normal) interleaves Box–Muller pairs
    into one flat array that consumers reshape to [n, 3], through
    three relayouts (stride-2 slice, [n, 2] stack, [n, 3] reshape) of
    the whole stream.  The fp32 fast path is *not* value-compatible with
    the f64 reference stream anyway (f32 physics diverges from the
    C double path within a step), so fp32 mode instead assigns each
    (component c, parcel p) one 64-bit Squares draw at counter
    ``ctr + c*n + p`` and derives both Box–Muller uniforms from it
    (radius from the high 24 bits, phase from the low 24 — all 64
    Squares output bits pass PractRand, Widynski 2022).  Everything is
    contiguous: no relayout at any point, and consumers index rows of
    the [3, n] result.  Counter advance stays 3n + 1 like the
    reference (c:5598-5630), so checkpoints interoperate with the
    parity path.

    Deterministic and bit-identical across backends (same integer
    chain as squares_bits); only transcendental rounding may differ by
    ulps between the CPU's and the GPU's libm.
    """
    base = ctr + jnp.arange(n, dtype=jnp.uint64)
    out = []
    for c in range(3):
        hi, lo = _squares(base + jnp.uint64(c * n))
        u_r = jnp.maximum((hi >> jnp.uint32(8)).astype(jnp.float32)
                          * jnp.float32(0.5 ** 24),
                          jnp.float32(0.5 ** 25))
        u_phi = (lo >> jnp.uint32(8)).astype(jnp.float32) \
            * jnp.float32(0.5 ** 24)
        r = jnp.sqrt(jnp.float32(-2.0) * jnp.log(u_r))
        out.append(r * jnp.cos(jnp.float32(2.0 * 3.141592653589793)
                               * u_phi))
    return jnp.stack(out), ctr + jnp.uint64(3 * n + 1)


def module_rng3(ctl_rng_type: int, ctr, n: int, dtype=jnp.float64,
                key=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Draw 3 standard normals per parcel as a component-major [3, n]
    array (the layout every consumer wants: diffusion/pbl use
    rs[0], rs[1], rs[2] directly, no [n, 3] relayout).

    f64 (parity mode) reproduces the reference's exact interleaved
    stream (module_rng method 1, c:5632-5648) and transposes —
    correctness over speed.  f32 uses the contiguous fast formulation
    (squares_normal3_f32).  rng_type 2 is threefry."""
    if ctl_rng_type in (0, 1):
        if dtype == jnp.float32:
            return jax.lax.optimization_barrier(
                squares_normal3_f32(ctr, n))
        rs, ctr = squares_normal(ctr, 3 * n)
        return jax.lax.optimization_barrier(
            (rs.astype(dtype).reshape(n, 3).T, ctr))
    k = jax.random.fold_in(jax.random.PRNGKey(0) if key is None else key,
                           ctr.astype(jnp.uint32))
    return (jax.random.normal(k, (3, n), dtype),
            ctr + jnp.uint64(3 * n + 1))


def module_rng(ctl_rng_type: int, ctr, n: int, method: int,
               key=None, dtype=jnp.float64
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dispatch like the reference ``module_rng`` (c:5535).

    Returns (values[n], new_ctr).  rng_type 0/1 -> Squares (type 0, the
    GSL per-thread stream, has no portable bitstream; Squares is used
    for determinism), 2 -> jax.random threefry.

    Squares runs the same native u64 chain on every backend, so the
    streams are bit-identical, which is what makes reference
    gpu_test-style cross-backend determinism possible
    (tests/gpu_test/run.sh:20-60).

    The draw is wrapped in ``lax.optimization_barrier`` so XLA
    materializes the integer bit chain exactly once per call instead
    of duplicating (rematerializing) it into each downstream consumer
    of ``values``.
    """
    if ctl_rng_type in (0, 1):
        if dtype == jnp.float32:
            # fp32 compute mode: same Squares bit stream and counter
            # advance, f32 arithmetic end-to-end (no emulated f64)
            if method == 0:
                u, ctr = squares_uniform_f32(ctr, n)
                return jax.lax.optimization_barrier((u[:n], ctr))
            return jax.lax.optimization_barrier(squares_normal_f32(ctr, n))
        if method == 0:
            u, ctr = squares_uniform(ctr, n)
            return jax.lax.optimization_barrier((u[:n].astype(dtype), ctr))
        rs, ctr = squares_normal(ctr, n)
        return jax.lax.optimization_barrier((rs.astype(dtype), ctr))
    # Threefry: counter folds into the key for stateless streams
    k = jax.random.fold_in(jax.random.PRNGKey(0) if key is None else key,
                           ctr.astype(jnp.uint32))
    if method == 0:
        vals = jax.random.uniform(k, (n,), dtype)
    else:
        vals = jax.random.normal(k, (n,), dtype)
    return vals, ctr + jnp.uint64(n + 1)
