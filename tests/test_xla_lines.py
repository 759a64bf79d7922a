"""Zebra line relaxation at the ragged shapes the retired fused line
kernels were tested at, checked by its defining property: after a sweep,
every line of the color swept last solves its equation exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cedar_jax.core.types import StencilKind
from cedar_jax.ops import lines2, stencil2
from test_kernels_2d import random_so as random_so2


@pytest.mark.parametrize("shape", [(40, 130), (37, 256)])
@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
@pytest.mark.parametrize("spike", [False, True])
def test_line_relax_last_color_lines_exact(shape, axis, nine, updown,
                                           spike):
    """After a zebra sweep the lines of the color swept last satisfy their
    equations against final neighbours, i.e. their residual vanishes
    (reference: each line solved directly with DPTTRF/DPTTRS).  Both the
    whole-line factorization and the interface-reduction (SPIKE) one."""
    rng = np.random.default_rng(sum(shape) + 2 * nine + spike)
    so = jnp.asarray(random_so2(rng, *shape, nine))
    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    q = jnp.asarray(rng.standard_normal(shape))
    b = jnp.asarray(rng.standard_normal(shape))
    setup = lines2.setup_lines_spike if spike else lines2.setup_lines
    sor = setup(so, kind=kind, axis=axis)
    relax = lines2.line_relax_x if axis == "x" else lines2.line_relax_y
    q1 = relax(so, q, b, sor, kind, updown)
    r = np.asarray(stencil2.residual(so, q1, b, kind))
    if axis == "y":
        r = r.T
    last = 0 if updown == "down" else 1
    scale = np.abs(np.asarray(b)).max()
    np.testing.assert_allclose(r[:, last::2], 0.0, atol=1e-11 * scale)
    # and the sweep moved the other color's lines too
    assert np.abs(r[:, 1 - last::2]).max() > 1e-6 * scale
