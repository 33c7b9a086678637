"""Squares RNG bit-exactness vs the reference algorithm.

Expected values were produced by an independent C harness implementing
the reference module_rng Squares path (mptrac.c:5598-5648) with
rng_ctr=0, n=9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mptrac_tpu.ops.rng import (module_rng, squares_bits, squares_normal,
                                squares_uniform)

UNIFORM_EXPECT = [
    0.50019086869416041, 0.37230243853187395, 0.93321980187789921,
    0.97512608556929115, 0.70875096120765446, 0.94715712524134599,
    0.46290613648115603, 0.62902480120175641, 0.33295340236518806,
    0.31277537867472194,
]

BM_EXPECT = [
    -0.81809926385881249, 0.84631233646884862, 0.36726023598006169,
    -0.05787012731304092, 0.78444320936169987, -0.27046436919426858,
    -0.85515586707187607, -0.89953897943083572, -0.56991740051087514,
]


def test_squares_uniform_bit_exact():
    u, ctr = squares_uniform(jnp.uint64(0), 9)
    assert np.array_equal(np.asarray(u), np.array(UNIFORM_EXPECT))
    assert int(ctr) == 10


def test_squares_normal_matches_reference():
    nrm, ctr = squares_normal(jnp.uint64(0), 9)
    # cosf/sinf evaluated in f32: matches to f32 rounding of the angle
    np.testing.assert_allclose(np.asarray(nrm), np.array(BM_EXPECT),
                               rtol=0, atol=5e-7)
    assert int(ctr) == 10


def test_counter_advance_chain():
    # successive module calls continue the counter like the global
    # rng_ctr in the reference
    u1, c1 = squares_uniform(jnp.uint64(0), 4)
    u2, c2 = squares_uniform(c1, 4)
    # regenerate from 0 with a longer draw: values at offset 5 must match
    ufull, _ = squares_uniform(jnp.uint64(0), 10)
    assert int(c1) == 5 and int(c2) == 10
    assert np.array_equal(np.asarray(u2), np.asarray(ufull)[5:10])


@pytest.mark.chip
def test_squares_on_accelerator(chip):
    """Cross-backend determinism (reference gpu_test analog): the
    Squares stream drawn on the GPU is bit-identical to the CPU stream
    and to the golden reference doubles."""
    def draw():
        h, lo = squares_bits(jnp.uint64(12345), 999)
        u, _ = squares_uniform(jnp.uint64(12345), 999)
        n, _ = squares_normal(jnp.uint64(777), 100)
        u0, _ = squares_uniform(jnp.uint64(0), 9)
        return [np.asarray(x) for x in (h, lo, u, n, u0)]

    h_gpu, l_gpu, u_gpu, n_gpu, u0_gpu = draw()
    with jax.default_device(jax.devices("cpu")[0]):
        h_cpu, l_cpu, u_cpu, n_cpu, _ = draw()
    # The integer stream and its correctly rounded u64 -> f64
    # conversion are exact on both backends.
    assert np.array_equal(h_gpu, h_cpu)
    assert np.array_equal(l_gpu, l_cpu)
    assert np.array_equal(u_gpu, u_cpu)
    assert np.array_equal(u0_gpu, np.array(UNIFORM_EXPECT))
    # Box-Muller evaluates cos/sin of an f32 angle: the two libms may
    # differ by an f32 ulp of the angle, as against the reference.
    np.testing.assert_allclose(n_gpu, n_cpu, rtol=0, atol=5e-7)


def test_module_rng_dispatch():
    vals, ctr = module_rng(1, jnp.uint64(0), 6, 1)
    assert vals.shape == (6,)
    vals2, _ = module_rng(2, jnp.uint64(0), 6, 1)  # threefry path
    assert vals2.shape == (6,)
    # odd n exercises the n+1 padding in Box-Muller
    vals3, ctr3 = module_rng(1, jnp.uint64(0), 7, 1)
    assert vals3.shape == (7,) and int(ctr3) == 8
