"""Fused Pallas (Triton) sweep kernel vs the XLA reference path.

The kernel compiles only for the GPU; here it runs in the Pallas
interpreter, which executes the same kernel body (window loads, masks,
scratch round trips, color phases) program by program.  The kernel must
match the XLA sweep (same term order; only FMA contraction may differ).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cedar_jax.core.types import StencilKind
from cedar_jax.ops import pallas2
from cedar_jax.ops.relax2 import point_relax as relax_xla, setup_recip
from cedar_jax.ops.stencil2 import residual


def _random_problem(rng, shape, nine):
    from test_kernels_2d import random_so

    so = jnp.asarray(random_so(rng, *shape, nine), jnp.float32)
    q = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    b = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    return so, q, b


def _check(so, q, b, kind, updown, fuse):
    ref = relax_xla(so, q, b, setup_recip(so), kind, updown)
    if fuse:
        got, res = pallas2.point_relax(so, q, b, kind, updown, True,
                                       interpret=True)
        np.testing.assert_allclose(
            np.asarray(residual(so, ref, b, kind)), np.asarray(res),
            atol=1e-4)
    else:
        got = pallas2.point_relax(so, q, b, kind, updown, interpret=True)
    # f32 sweep: same terms in the same order, at most FMA contraction
    # differs, so agreement is to a few ulps of the O(10) values
    np.testing.assert_allclose(np.asarray(ref), np.asarray(got), atol=1e-5)


@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_pallas_sweep_matches_xla(nine, updown):
    rng = np.random.default_rng(3 + nine)
    so, q, b = _random_problem(rng, (256, 256), nine)
    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    assert pallas2.supported(q.shape, q.dtype, kind)
    _check(so, q, b, kind, updown, False)
    _check(so, q, b, kind, updown, True)


# odd, non-power-of-two and smaller-than-one-window shapes: the masked
# window loads, the clamped low-edge windows and the owned-tile stores
SHAPES = [(37, 150), (130, 300), (5, 7), (64, 121)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("fuse", [False, True])
def test_pallas_sweep_shapes(shape, nine, fuse):
    rng = np.random.default_rng(sum(shape) + nine)
    so, q, b = _random_problem(rng, shape, nine)
    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    _check(so, q, b, kind, "down" if fuse else "up", fuse)


def test_supported_gates():
    f32 = jnp.float32
    five = StencilKind.five_pt
    nine = StencilKind.nine_pt
    assert pallas2.supported((4096, 4096), f32, five)
    assert pallas2.supported((2048, 2048), f32, nine)
    # any extent: windows are masked at the grid edge
    assert pallas2.supported((2049, 2047), f32, five)
    assert pallas2.supported((3, 3), f32, nine)
    assert pallas2.supported((8192, 8192), f32, five)
    # float64 stays on the XLA path
    assert not pallas2.supported((4096, 4096), jnp.float64, five)
    # a periodic axis needs at least one halo of extent to wrap into
    assert pallas2.supported((3, 64), f32, five, (True, False))
    assert not pallas2.supported((2, 64), f32, five, (True, False))
    assert not pallas2.supported((64, 4), f32, nine, (False, True))


def test_padded_dispatch_matches_xla():
    """Unaligned shapes need no padding: the edge windows are masked."""
    rng = np.random.default_rng(9)
    so, q, b = _random_problem(rng, (401, 387), True)
    _check(so, q, b, StencilKind.nine_pt, "down", False)


@pytest.mark.parametrize("kind", [StencilKind.five_pt, StencilKind.nine_pt])
def test_halo_and_grid(kind):
    """The halo covers every color phase plus the residual, and each
    window keeps a non-empty owned tile."""
    hx, hy = pallas2.halo(kind)
    assert hx == pallas2.ncolors(kind) + 1
    assert hy >= hx and hy % 4 == 0
    wx, wy = pallas2.WINDOW
    assert wx & (wx - 1) == 0 and wy & (wy - 1) == 0
    assert wx - 2 * hx > 0 and wy - 2 * hy > 0
