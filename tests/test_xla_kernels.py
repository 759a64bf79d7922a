"""The plain XLA kernels against the Fortran-transcription oracles at the
larger, ragged shapes the retired fused kernels were tested at.

These are the kernels every path runs now (3D sweeps and transfers, 2D
transfers) or that the fused GPU sweep is checked against (2D sweeps);
``test_kernels_2d``/``test_kernels_3d`` cover the small shapes.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import oracles as orc2
import oracles3 as orc3
from cedar_jax.core.types import StencilKind
from cedar_jax.ops import interp2, interp3, relax2, relax3
from test_kernels_2d import random_so as random_so2
from test_kernels_3d import random_so as random_so3

SHAPES3 = [(24, 16, 40), (32, 16, 40), (27, 18, 35), (48, 32, 32),
           (32, 32, 40)]
SHAPES2 = [(256, 256), (129, 257), (200, 300), (256, 384)]


@pytest.mark.parametrize("shape", SHAPES3)
@pytest.mark.parametrize("twenty_seven", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_xla_sweep3_vs_fortran_oracle(shape, twenty_seven, updown):
    rng = np.random.default_rng(sum(shape) + twenty_seven)
    so = random_so3(rng, *shape, twenty_seven)
    kind = (StencilKind.twenty_seven_pt if twenty_seven
            else StencilKind.seven_pt)
    q0 = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    qo = orc3.relax_gs(
        orc3.pad_ghost_so(so), orc3.pad_ghost(q0), orc3.pad_ghost(b),
        orc3.pad_ghost(1.0 / so[orc3.KP]), 14 if twenty_seven else 4, updown,
    )
    qm = relax3.point_relax(
        jnp.asarray(so), jnp.asarray(q0), jnp.asarray(b),
        relax3.setup_recip(jnp.asarray(so)), kind, updown,
    )
    np.testing.assert_allclose(orc3.unpad(qo), np.asarray(qm), atol=1e-11)


@pytest.mark.parametrize("shape", SHAPES3[2:])
@pytest.mark.parametrize("twenty_seven", [False, True])
def test_xla_transfers3_vs_fortran_oracle(shape, twenty_seven):
    """Interpolation setup, restriction and interp-add; the 7-point
    operator goes to the oracle embedded in the 27-point storage."""
    rng = np.random.default_rng(3 * sum(shape) + twenty_seven)
    so = random_so3(rng, *shape, twenty_seven)
    kind = (StencilKind.twenty_seven_pt if twenty_seven
            else StencilKind.seven_pt)
    so27 = so if twenty_seven else np.concatenate(
        [so, np.zeros((10,) + shape)])
    g = orc3.pad_ghost_so(so27)
    nc = [(n - 1) // 2 + 1 for n in shape]
    dims_f = [n + 2 for n in shape]
    dims_c = [n + 2 for n in nc]
    cio = orc3.setup_interp_oi(g, *dims_f, *dims_c)
    cim = np.asarray(interp3.setup_interp(jnp.asarray(so), kind))
    np.testing.assert_allclose(cio[:, 1:, 1:, 1:], cim, atol=1e-12)

    qf = rng.standard_normal(shape)
    rco = orc3.restrict(cio, orc3.pad_ghost(qf), *dims_c)
    rcm = np.asarray(interp3.restrict(jnp.asarray(cim), jnp.asarray(qf)))
    np.testing.assert_allclose(orc3.unpad(rco), rcm, atol=1e-11)

    qcg = np.zeros(dims_c)
    qcg[1:-1, 1:-1, 1:-1] = rng.standard_normal(nc)
    resg = orc3.pad_ghost(rng.standard_normal(shape))
    q0 = rng.standard_normal(shape)
    qao = orc3.interp_add(cio, g, orc3.pad_ghost(q0), qcg, resg, *dims_f,
                          *dims_c)
    qam = np.asarray(interp3.interp_add(
        jnp.asarray(cim), jnp.asarray(so),
        jnp.asarray(qcg[1:-1, 1:-1, 1:-1]),
        jnp.asarray(resg[1:-1, 1:-1, 1:-1]), jnp.asarray(q0),
    ))
    np.testing.assert_allclose(orc3.unpad(qao), qam, atol=1e-11)


@pytest.mark.parametrize("shape", SHAPES2 + [(37, 256), (40, 130)])
@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_xla_sweep2_vs_fortran_oracle(shape, nine, updown):
    rng = np.random.default_rng(sum(shape) + nine)
    so = random_so2(rng, *shape, nine)
    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    q0 = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    sor = orc2.pad_ghost(1.0 / so[orc2.KO])
    qo = orc2.relax_gs(orc2.pad_ghost_so(so), orc2.pad_ghost(q0),
                       orc2.pad_ghost(b), sor, 5 if nine else 3, updown)
    qm = relax2.point_relax(
        jnp.asarray(so), jnp.asarray(q0), jnp.asarray(b),
        relax2.setup_recip(jnp.asarray(so)), kind, updown,
    )
    np.testing.assert_allclose(orc2.unpad(qo), np.asarray(qm), atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES2)
@pytest.mark.parametrize("nine", [False, True])
def test_xla_transfers2_vs_fortran_oracle(shape, nine):
    nx, ny = shape
    rng = np.random.default_rng(nx * ny + nine)
    so = random_so2(rng, nx, ny, nine)
    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    g = orc2.pad_ghost_so(so)
    nxc, nyc = (nx - 1) // 2 + 1, (ny - 1) // 2 + 1
    iif, jjf, iic, jjc = nx + 2, ny + 2, nxc + 2, nyc + 2
    cio = orc2.setup_interp_oi(g, iif, jjf, iic, jjc, 0 if nine else 1)
    cim = np.asarray(interp2.setup_interp(jnp.asarray(so), kind))
    np.testing.assert_allclose(cio[:, 1:, 1:], cim, atol=1e-13)

    qf = rng.standard_normal((nx, ny))
    rco = orc2.restrict(cio, orc2.pad_ghost(qf), iic, jjc)
    rcm = np.asarray(interp2.restrict(jnp.asarray(cim), jnp.asarray(qf)))
    np.testing.assert_allclose(orc2.unpad(rco), rcm, atol=1e-12)

    qcg = np.zeros((iic, jjc))
    qcg[1:-1, 1:-1] = rng.standard_normal((nxc, nyc))
    resg = orc2.pad_ghost(rng.standard_normal((nx, ny)))
    q0 = rng.standard_normal((nx, ny))
    qao = orc2.interp_add(cio, g, orc2.pad_ghost(q0), qcg, resg, iif, jjf,
                          iic, jjc)
    qam = np.asarray(interp2.interp_add(
        jnp.asarray(cim), jnp.asarray(so), jnp.asarray(qcg[1:-1, 1:-1]),
        jnp.asarray(resg[1:-1, 1:-1]), jnp.asarray(q0),
    ))
    np.testing.assert_allclose(orc2.unpad(qao), qam, atol=1e-12)
