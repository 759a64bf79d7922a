"""Multi-device (sharded) execution tests on the virtual 8-CPU mesh.

The analogue of the reference's MPI test tier (SURVEY §4): halo-exchange
property tests become sharded-vs-unsharded exactness checks per kernel (XLA
inserts the halo collective-permutes for the shifted reads); the
coarse-solver equivalence tests (LU vs redistributed, <1e-10 at np=16,
test/2d/mpi/test_cgredist.cc) become sharded-vs-serial solve agreement
under different agglomeration policies.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from cedar_jax import FivePt, SevenPt, Solver2, Solver3, gallery
from cedar_jax.config import Config
from cedar_jax.core.types import StencilKind
from cedar_jax.parallel import DistSolver2, DistSolver3, make_mesh
from cedar_jax.parallel.policy import batched_sharding, func_sharding
from cedar_jax.ops.relax2 import point_relax, setup_recip
from cedar_jax.ops.stencil2 import residual as residual2
from cedar_jax.ops.interp2 import interp_add, restrict, setup_interp
from cedar_jax.ops.stencil3 import residual as residual3


@pytest.fixture(scope="module")
def mesh2():
    return make_mesh(2, devices=jax.devices("cpu"))


@pytest.fixture(scope="module")
def mesh3():
    return make_mesh(3, devices=jax.devices("cpu"))


CONF = {"log": [], "solver": {"tol": 1e-9, "max-iter": 30}}


def test_mesh_shapes(mesh2, mesh3):
    assert int(np.prod(list(mesh2.shape.values()))) == 8
    assert tuple(mesh3.shape.values()) == (2, 2, 2)


def test_halo_kernel_exactness(mesh2):
    """Sharded kernels must equal unsharded to reassociation roundoff (no
    reductions are involved; only the fusion order of the stencil-term sums
    may differ): the sharded-boundary reads are XLA's halo exchange — the
    analogue of the reference's ghost-value property tests
    (test/2d/mpi/test_halo.h)."""
    rng = np.random.default_rng(5)
    nx, ny = 64, 32
    from test_kernels_2d import random_so

    so = jnp.asarray(random_so(rng, nx, ny, True))
    q = jnp.asarray(rng.standard_normal((nx, ny)))
    b = jnp.asarray(rng.standard_normal((nx, ny)))
    kind = StencilKind.nine_pt

    sh_f = func_sharding(mesh2, P("x", "y"))
    sh_so = batched_sharding(mesh2, P("x", "y"), 1)
    so_s = jax.device_put(so, sh_so)
    q_s = jax.device_put(q, sh_f)
    b_s = jax.device_put(b, sh_f)

    rec = setup_recip(so)
    for updown in ("down", "up"):
        ref = point_relax(so, q, b, rec, kind, updown)
        got = jax.jit(
            lambda s, x, y: point_relax(
                s, x, y, setup_recip(s), kind, updown  # noqa: B023
            )
        )(so_s, q_s, b_s)
        np.testing.assert_allclose(
            np.asarray(ref), np.asarray(got), atol=1e-13)

    ref = residual2(so, q, b, kind)
    got = jax.jit(lambda s, x, y: residual2(s, x, y, kind))(so_s, q_s, b_s)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(got), atol=1e-13)

    ci = setup_interp(so, kind)
    ref = restrict(ci, q)
    got = jax.jit(restrict)(jax.device_put(ci, batched_sharding(
        mesh2, P(None, None), 1)), q_s)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(got), atol=1e-13)


def test_dist2_matches_serial(mesh2):
    n = 96
    so = gallery.poisson(n, n)
    b = gallery.poisson_rhs(n, n)
    s_ser = Solver2(so, FivePt, Config(CONF))
    x_ser = s_ser.solve(b)
    s_dist = DistSolver2(so, FivePt, Config(CONF), mesh2)
    # fine level sharded over both axes, coarse levels agglomerated
    assert s_dist.specs[0] == P("x", "y")
    assert s_dist.specs[-1] == P(None, None)
    x_dist = s_dist.solve(b)
    assert len(s_dist.history) == len(s_ser.history)
    assert float(jnp.max(jnp.abs(x_ser - jax.device_get(x_dist)))) < 1e-12


def test_dist2_agglomeration_equivalence(mesh2):
    """Different agglomeration thresholds agree (reference: LU vs manual
    redistribution path agree <1e-10, test/2d/mpi/test_cgredist.cc)."""
    n = 64
    so = gallery.poisson(n, n)
    b = gallery.poisson_rhs(n, n)
    eager = DistSolver2(so, FivePt, Config(dict(CONF)), mesh2)
    lazy_conf = dict(CONF)
    lazy_conf["redist"] = {"min-local": 10**9}  # replicate everything
    lazy = DistSolver2(so, FivePt, Config(lazy_conf), mesh2)
    assert eager.specs[0] != lazy.specs[0]
    xa = eager.solve(b)
    xb = lazy.solve(b)
    assert float(jnp.max(jnp.abs(xa - xb))) < 1e-10


def test_dist3_matches_serial(mesh3):
    n = 24
    so = gallery.poisson3(n, n, n)
    b = gallery.poisson3_rhs(n, n, n)
    s_ser = Solver3(so, SevenPt, Config(CONF))
    x_ser = s_ser.solve(b)
    s_dist = DistSolver3(so, SevenPt, Config(CONF), mesh3)
    assert s_dist.specs[0] == P("x", "y", "z")
    x_dist = s_dist.solve(b)
    r = residual3(so, jax.device_get(x_dist), b, SevenPt)
    rel = float(jnp.sqrt(jnp.sum(r * r)) / jnp.sqrt(jnp.sum(b * b)))
    assert rel < 1e-9
    assert float(jnp.max(jnp.abs(x_ser - jax.device_get(x_dist)))) < 1e-12


def test_dist2_irregular_size(mesh2):
    """Non-divisible fine extents are inert-padded to the mesh (the
    mesh analogue of the reference's uneven block partition,
    include/cedar/mpi/block_partition.h:8-34) — the fine level is
    actually sharded, and the solve stays correct."""
    n = 75
    so = gallery.poisson(n, 64)
    b = gallery.poisson_rhs(n, 64)
    s_dist = DistSolver2(so, FivePt, Config(CONF), mesh2)
    assert s_dist.shapes[0][0] % mesh2.shape["x"] == 0  # padded
    assert s_dist.specs[0][0] == "x"                    # and sharded
    x = s_dist.solve(b)
    assert x.shape == (n, 64)
    r = residual2(so, jax.device_get(x), b, FivePt)
    rel = float(jnp.sqrt(jnp.sum(r * r)) / jnp.sqrt(jnp.sum(b * b)))
    assert rel < 1e-9


def test_dist2_odd_extent_partitioned_matches_serial(mesh2):
    """Canonical 2^k+1 MG sizing (odd extents): the inert padding pads to
    a multiple of 2^L * mesh_dim (L = deepest level clearing min-local),
    so EVERY feasible level stays partitioned, and the padded solve's
    trajectory on the real region equals the serial solver's (pad rows
    are decoupled: zero couplings, unit diagonal).  Reference behavior:
    parity-aware uneven partition per level, 2d/mpi/solver.h:176-196 +
    include/cedar/mpi/block_partition.h:8-34."""
    n = 129
    so = gallery.poisson(n, n)
    b = gallery.poisson_rhs(n, n)
    s_ser = Solver2(so, FivePt, Config(CONF))
    x_ser = s_ser.solve(b)
    s_dist = DistSolver2(so, FivePt, Config(CONF), mesh2)
    # padded to 2^L * mesh_dim multiples: levels 0-2 fully partitioned,
    # level 3 (18^2: 18 % 4 != 0, local 9 >= min_local) still on "y"
    assert s_dist.shapes[0] == (144, 144)
    assert s_dist.specs[0] == P("x", "y")
    assert s_dist.specs[1] == P("x", "y")
    assert s_dist.specs[2] == P("x", "y")
    assert s_dist.specs[3][1] == "y"
    assert len(s_dist.levels) == len(s_ser.levels)
    x_dist = s_dist.solve(b)
    assert x_dist.shape == (n, n)
    assert s_dist.history == pytest.approx(s_ser.history, rel=1e-10)
    assert float(jnp.max(jnp.abs(x_ser - jax.device_get(x_dist)))) < 1e-10


def test_dist3_plane_relax_matches_serial(mesh3):
    """Plane relaxation under sharding: the embedded plane hierarchies
    DISTRIBUTE — batch axis over the out-of-plane mesh axis and in-plane
    dims over the in-plane axes — the analogue of the reference's sliced
    plane communicators (include/cedar/3d/mpi/relax_planes.h:219-298)."""
    n = 16
    so = gallery.diag_diffusion3(n, n, n, 1.0, 1.0, 1e-3)
    b = gallery.poisson3_rhs(n, n, n)
    conf = {"log": [], "solver": {"relaxation": "plane-xy",
                                  "tol": 1e-9, "max-iter": 10}}
    from cedar_jax import Solver3 as _S3

    x_ser = _S3(so, SevenPt, Config(dict(conf))).solve(b)
    s_dist = DistSolver3(so, SevenPt, Config(dict(conf)), mesh3)
    # fine level (16^3, sharded P(x,y,z)): plane hierarchy batch axis on
    # "z" (16 xy-planes over 2), fine 2D level in-plane on ("x","y")
    # (16/2 = 8 >= min_local); embedded coarse (8x8) agglomerates
    hier = s_dist.levels[0].planes["xy"]
    assert hier[0].so.sharding.spec == P("z", None, "x", "y")
    assert hier[1].so.sharding.spec == P("z", None, None, None)
    x_dist = s_dist.solve(b)
    assert float(jnp.max(jnp.abs(x_ser - jax.device_get(x_dist)))) < 1e-12


def test_line_relax_sharded_along_line_axis(mesh2):
    """Zebra line relaxation with the grid sharded ALONG the line axis:
    the PCR tridiagonal solves span shards (XLA inserts a collective per
    reduction step — see docs in NOTES.md §distributed-lines), and must
    agree with the serial solver.  Analogue of the reference's distributed
    line-relax tests at np ∈ {1,7,16} (test/2d/mpi/test_lines.cc)."""
    n = 64
    so = gallery.fe(n, n)
    b = gallery.poisson_rhs(n, n)
    conf = {"log": [], "solver": {"relaxation": "line-x", "tol": 1e-8,
                                  "max-iter": 20}}
    xs = Solver2(so, StencilKind.nine_pt, Config(dict(conf))).solve(b)
    xd = DistSolver2(so, StencilKind.nine_pt, Config(dict(conf)),
                     mesh2).solve(b)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(xd), atol=1e-10)


def test_line_relax_dist_interface_reduction(mesh2):
    """line-xy with both axes sharded runs the distributed SPIKE
    (interface-reduction) workspace — the analogue of the reference's
    one-gather-per-color LineSolve_A/B/C scheme
    (src/2d/ftn/mpi/BMG2_SymStd_relax_lines_x.f90:156-277) — and agrees
    with the serial solver."""
    from cedar_jax.ops.lines2 import DistSpikeLines

    n = 64
    so = gallery.diag_diffusion(n, n, 50.0, 1.0)
    b = gallery.poisson_rhs(n, n)
    conf = {"log": [], "solver": {"relaxation": "line-xy", "tol": 1e-8,
                                  "max-iter": 25}}
    s_ser = Solver2(so, FivePt, Config(dict(conf)))
    s_dist = DistSolver2(so, FivePt, Config(dict(conf)), mesh2)
    assert isinstance(s_dist.levels[0].sor_x, DistSpikeLines)
    assert isinstance(s_dist.levels[0].sor_y, DistSpikeLines)
    xs = s_ser.solve(b)
    xd = s_dist.solve(b)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(xd), atol=1e-10)


def test_ml_relax_disables_dist_interface_reduction(mesh2):
    """solver.ml-relax.enabled keeps distributed lines on the log-depth
    algorithm (the reference's "n-level" ml_relax variant) and still
    matches the serial solve."""
    from cedar_jax.ops.lines2 import DistSpikeLines

    n = 64
    so = gallery.fe(n, n)
    b = gallery.poisson_rhs(n, n)
    conf = {"log": [], "solver": {"relaxation": "line-x", "tol": 1e-8,
                                  "max-iter": 20,
                                  "ml-relax": {"enabled": True}}}
    xs = Solver2(so, StencilKind.nine_pt, Config(dict(conf))).solve(b)
    sd = DistSolver2(so, StencilKind.nine_pt, Config(dict(conf)), mesh2)
    assert not isinstance(sd.levels[0].sor_x, DistSpikeLines)
    xd = sd.solve(b)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(xd), atol=1e-10)


def test_dist2_periodic_matches_serial(mesh2):
    """Sharded periodic solve: the wrap reads become collective permutes
    across the mesh edge (the reference's periodic halo masks,
    test/2d/mpi/test_halo.h:117-179), and the solve matches serial."""
    n = 64
    so = gallery.poisson(n, n)
    b = gallery.poisson_rhs(n, n)
    conf = {"log": [], "solver": {"tol": 1e-8, "max-iter": 20},
            "grid": {"periodic": [True, True]}}
    xs = Solver2(so, FivePt, Config(dict(conf))).solve(b)
    sd = DistSolver2(so, FivePt, Config(dict(conf)), mesh2)
    assert sd.specs[0] == P("x", "y")
    xd = sd.solve(b)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(xd), atol=1e-11)


@pytest.mark.parametrize("shape", [(8, 1), (2, 4), (1, 8)])
def test_dist2_mesh_shape_diversity(shape):
    """Skewed/degenerate process grids (the reference sweeps {3x3,3x2,2x3},
    test_halo.h): the solve matches serial on every mesh shape."""
    m = make_mesh(2, devices=jax.devices("cpu"), shape=shape)
    n = 64
    so = gallery.poisson(n, n)
    b = gallery.poisson_rhs(n, n)
    xs = Solver2(so, FivePt, Config(CONF)).solve(b)
    sd = DistSolver2(so, FivePt, Config(CONF), m)
    xd = sd.solve(b)
    assert float(jnp.max(jnp.abs(xs - jax.device_get(xd)))) < 1e-11


def test_manual_redist_path_end_to_end(mesh2):
    """redist.search.strategy "manual": the per-level process-grid path
    (reference: test/2d/mpi/test-cgredist-1.json, path entries map to
    use/drop of each fixed mesh axis; entries beyond the path length use
    its last entry, like the reference's terminal [1,1]) controls the
    level shardings, and the solve matches the serial solver."""
    n = 64
    so = gallery.poisson(n, n)
    b = gallery.poisson_rhs(n, n)
    conf = {"log": [], "solver": {"tol": 1e-9, "max-iter": 30},
            "redist": {"search": {"strategy": "manual",
                                  "path": [[4, 2], [1, 2], [1, 1]]}}}
    s = DistSolver2(so, FivePt, Config(dict(conf)), mesh2)
    specs = [tuple(sp) + (None,) * (2 - len(sp)) for sp in s.specs]
    assert specs[0] == ("x", "y")
    assert specs[1] == (None, "y")
    for sp in specs[2:]:
        assert sp == (None, None)
    xs = Solver2(so, FivePt, Config({"log": [],
                                     "solver": {"tol": 1e-9,
                                                "max-iter": 30}})).solve(b)
    xd = s.solve(b)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(xd), atol=1e-10)


def test_dist3_odd_extent_partitioned_matches_serial(mesh3):
    """3D odd (2^k+1) extents: the inert padding partitions the fine
    level on the (2,2,2) mesh and the trajectory matches serial."""
    n = 17
    so = gallery.poisson3(n, n, n)
    b = gallery.poisson3_rhs(n, n, n)
    conf = {"log": [], "solver": {"tol": 1e-9, "max-iter": 12}}
    x_ser = Solver3(so, SevenPt, Config(dict(conf))).solve(b)
    s_dist = DistSolver3(so, SevenPt, Config(dict(conf)), mesh3)
    assert all(d % 2 == 0 for d in s_dist.shapes[0])
    assert s_dist.specs[0] == P("x", "y", "z")
    x_dist = s_dist.solve(b)
    assert x_dist.shape == (n, n, n)
    assert float(jnp.max(jnp.abs(x_ser - jax.device_get(x_dist)))) < 1e-9


@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("spec", [P("x", "y"), P("x", None), P(None, "y")])
def test_sharded_sweep_matches_serial_2d(mesh2, nine, spec):
    """The XLA sweep (and its residual) on a sharded grid equals the
    serial one: color masks anchor to global indices and the shifted reads
    become halo exchanges (float64: to reassociation roundoff)."""
    from test_kernels_2d import random_so

    rng = np.random.default_rng(11 + nine)
    nx, ny = 256, 480
    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    so = jnp.asarray(random_so(rng, nx, ny, nine))
    q = jnp.asarray(rng.standard_normal((nx, ny)))
    b = jnp.asarray(rng.standard_normal((nx, ny)))
    so_s = jax.device_put(so, batched_sharding(mesh2, spec, 1))
    q_s = jax.device_put(q, func_sharding(mesh2, spec))
    b_s = jax.device_put(b, func_sharding(mesh2, spec))

    def sweep(so, q, b):
        x = point_relax(so, q, b, setup_recip(so), kind, "down")
        x = point_relax(so, x, b, setup_recip(so), kind, "up")
        return x, residual2(so, x, b, kind)

    ref = sweep(so, q, b)
    got = jax.jit(sweep)(so_s, q_s, b_s)
    assert got[0].sharding.is_equivalent_to(func_sharding(mesh2, spec), 2)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(np.asarray(r), np.asarray(g), atol=1e-12)


@pytest.mark.parametrize("twenty_seven", [False, True])
@pytest.mark.parametrize("spec", [P("x", "y", "z"), P(None, None, "z")])
def test_sharded_sweep_matches_serial_3d(mesh3, twenty_seven, spec):
    from cedar_jax.ops import relax3
    from test_kernels_3d import random_so

    rng = np.random.default_rng(13 + twenty_seven)
    shape = (32, 48, 64)
    kind = (StencilKind.twenty_seven_pt if twenty_seven
            else StencilKind.seven_pt)
    so = jnp.asarray(random_so(rng, *shape, twenty_seven))
    q = jnp.asarray(rng.standard_normal(shape))
    b = jnp.asarray(rng.standard_normal(shape))

    def sweep(so, q, b):
        x = relax3.point_relax(so, q, b, relax3.setup_recip(so), kind,
                               "down")
        return x, residual3(so, x, b, kind)

    ref = sweep(so, q, b)
    got = jax.jit(sweep)(jax.device_put(so, batched_sharding(mesh3, spec, 1)),
                         jax.device_put(q, func_sharding(mesh3, spec)),
                         jax.device_put(b, func_sharding(mesh3, spec)))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(np.asarray(r), np.asarray(g), atol=1e-12)
