"""2D zebra line relaxation with batched tridiagonal (Thomas/LDLᵀ) solves.

Reference: BMG2_SymStd_relax_lines_{x,y}.f90 + BMG2_SymStd_SETUP_lines_{x,y}.f90.
Semantics reproduced exactly:

* zebra ordering — DOWN relaxes rows of odd interior index first
  (Fortran JBEG_START=3), then even; UP reverses (:81-96);
* per line: rhs = qf + all couplings to the OTHER rows at current values,
  then an exact tridiagonal solve along the line with diag = KO and
  off-diagonal = -KW (LAPACK DPTTRF/DPTTRS in the reference);
* the LDLᵀ factorization is precomputed once at setup and stored, like the
  reference's SOR workspace.

All lines of one color are independent, so the tridiagonal solves are
batched: a `lax.scan` along the line direction carries every line of the
color at once (two sweeps of length nx).  A GPU kernel (one program per
group of lines) could replace the scan; the interface would not change.

y-lines reuse the x-line implementation on transposed operands (under
transpose W↔S swap, SW↦SWᵀ, NW↦NWᵀ).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cedar_jax.core.parity import _split_axis
from cedar_jax.core.shift import shift2
from cedar_jax.core.types import Dir2, StencilKind


def _cols(a: jnp.ndarray, parity: int) -> jnp.ndarray:
    """``a[..., parity::2]`` via the reshape-based parity split."""
    return _split_axis(a, a.ndim - 1)[parity]


def setup_lines(so: jnp.ndarray, kind: StencilKind, axis: str) -> jnp.ndarray:
    """LDLᵀ factors of each grid line along ``axis`` ('x' or 'y').

    Returns ``(2, nx, ny)``: plane 0 = 1/d(i), plane 1 = l(i) = e(i)/d(i-1)
    with e = true off-diagonal (= -stored W or S).  Factorization runs as a
    scan along the line (same recurrence DPTTRF uses).
    """
    if axis == "y":
        so = _transpose_so(so, kind)
    diag = so[Dir2.O]          # (nx, ny), line direction = axis 0
    e = -so[Dir2.W]            # e[i] couples point i-1 and i (e[0] unused)

    def fac_step(d_prev, inputs):
        a_i, e_i = inputs
        l_i = e_i / d_prev
        d_i = a_i - l_i * e_i
        return d_i, (d_i, l_i)

    d0 = diag[0]
    _, (ds, ls) = jax.lax.scan(
        fac_step, d0, (diag[1:], e[1:])
    )
    d_all = jnp.concatenate([d0[None], ds], axis=0)
    l_all = jnp.concatenate([jnp.zeros_like(d0)[None], ls], axis=0)
    out = jnp.stack([1.0 / d_all, l_all])
    if axis == "y":
        out = out.transpose(0, 2, 1)
    return out


def _shift0(a: jnp.ndarray, s: int, fill: float) -> jnp.ndarray:
    """out[i] = a[i + s] along axis 0, filled with ``fill`` out of range."""
    n = a.shape[0]
    if s == 0:
        return a
    pad = jnp.full((abs(s),) + a.shape[1:], fill, a.dtype)
    if s > 0:
        return jnp.concatenate([a[s:], pad], axis=0)
    return jnp.concatenate([pad, a[:s]], axis=0)


def _pcr_solve(lo: jnp.ndarray, dg: jnp.ndarray, up: jnp.ndarray,
               d: jnp.ndarray) -> jnp.ndarray:
    """Parallel cyclic reduction for tridiagonal systems along axis 0.

    ``lo[i]`` couples row i to i-1 (lo[0] = 0), ``up[i]`` to i+1
    (up[n-1] = 0).  O(log n) data-parallel steps instead of the O(n)
    sequential Thomas recurrence (the reference's LAPACK DPTTRF/DPTTRS
    and Thomas loops are latency-bound on a data-parallel machine).  Out-of-range rows enter as identity equations
    (diag 1, couplings/rhs 0).
    """
    n = d.shape[0]
    s = 1
    while s < n:
        blo = _shift0(dg, -s, 1.0)
        bhi = _shift0(dg, s, 1.0)
        alpha = -lo / blo
        gamma = -up / bhi
        dg = (dg + alpha * _shift0(up, -s, 0.0)
              + gamma * _shift0(lo, s, 0.0))
        d = (d + alpha * _shift0(d, -s, 0.0)
             + gamma * _shift0(d, s, 0.0))
        lo = alpha * _shift0(lo, -s, 0.0)
        up = gamma * _shift0(up, s, 0.0)
        s *= 2
    return d / dg


def _cyclic_solve(lo_full: jnp.ndarray, dg: jnp.ndarray, up_full: jnp.ndarray,
                  d: jnp.ndarray) -> jnp.ndarray:
    """Cyclic (periodic-axis) tridiagonal solve via Sherman–Morrison.

    ``lo_full[0]`` and ``up_full[n-1]`` hold the wrap couplings (point 0 to
    point n-1 and back).  The reference solves these with its PER_x/PER_y
    branches (BMG2_SymStd_relax_lines_x.f90:72-172 + SETUP_lines_x.f90);
    here the cyclic system ``A_cyc = A' + u vᵀ`` is reduced to TWO
    tridiagonal solves with the same modified matrix, batched into ONE PCR
    call (the second rhs rides as extra batch columns):

        A' = A_cyc with  d[0]   -= γ,
                         d[n-1] -= cl·cu/γ,  corners dropped
        u  = (γ, 0, …, cl),   v = (1, 0, …, cu/γ)
        x  = y − z · (v·y)/(1 + v·z),   A'y = d,  A'z = u
    """
    n = d.shape[0]
    cl = lo_full[0]          # A[0, n-1] (per line)
    cu = up_full[n - 1]      # A[n-1, 0]
    gamma = -dg[0]
    dg_mod = dg.at[0].add(-gamma).at[n - 1].add(-cl * cu / gamma)
    lo = lo_full.at[0].set(0.0)
    up = up_full.at[n - 1].set(0.0)
    u = jnp.zeros_like(d).at[0].set(gamma).at[n - 1].set(cl)

    nb = d.shape[1]
    rhs2 = jnp.concatenate([d, u], axis=1)
    sol = _pcr_solve(
        jnp.tile(lo, (1, 2)), jnp.tile(dg_mod, (1, 2)),
        jnp.tile(up, (1, 2)), rhs2,
    )
    y, z = sol[:, :nb], sol[:, nb:]
    vy = y[0] + (cu / gamma) * y[n - 1]
    vz = z[0] + (cu / gamma) * z[n - 1]
    return y - z * (vy / (1.0 + vz))


# PCR beats the sequential scan once lines are long enough to be
# latency-bound; short lines (coarse levels) keep the Thomas scan.
_PCR_MIN_LEN = 64


# ---------------------------------------------------------------------------
# Cached interface-reduction (SPIKE) solver for long lines.
#
# PCR recomputes the matrix reduction every solve: log2(n) full-array
# passes over four operands — ~700 MB of memory traffic per color at 2048²
# (counted from shapes).
# The reference's distributed line algorithm (LineSolve_A/B/C,
# src/2d/ftn/mpi/BMG2_SymStd_relax_lines_x.f90:156-277) is the right
# single-device algorithm too, with "rank" -> "block of the line":
# eliminate block interiors against cached factors (two scans of depth
# L-2), solve the 2B-interface reduced TRIDIAGONAL with a
# tiny PCR, back-substitute with cached spike vectors.  Per solve this
# reads each operand once (~50 MB at 2048²) instead of log2(n) times.
# ---------------------------------------------------------------------------

from typing import NamedTuple  # noqa: E402


class SpikeFactors(NamedTuple):
    """Matrix-dependent workspace for one color's line solves.

    Interior arrays are laid out (L-2, B, nb) — block-local position
    leading so `lax.scan` slices are contiguous; B = blocks per line,
    nb = lines of this color.
    """
    l: jnp.ndarray        # forward-elimination multipliers (0 at t=0)
    dinv: jnp.ndarray     # 1 / pivots
    upi: jnp.ndarray      # interior superdiagonal (0 at t=L-3)
    p: jnp.ndarray        # (Li, B, nb) cached spike toward block-first
    q: jnp.ndarray        # (Li, B, nb) cached spike toward block-last
    up0: jnp.ndarray      # (B, nb) row-0 coupling to its interior
    loL: jnp.ndarray      # (B, nb) row-(L-1) coupling to its interior
    rlo: jnp.ndarray      # (2B, nb) reduced-system subdiagonal
    rdg: jnp.ndarray      # (2B, nb) reduced-system diagonal
    rup: jnp.ndarray      # (2B, nb) reduced-system superdiagonal


class SpikeLines(NamedTuple):
    """Per-color SPIKE factors (index = line parity)."""
    even: SpikeFactors
    odd: SpikeFactors


def _spike_block_len(n: int) -> int:
    """Block length ≈ sqrt(n): balances scan depth (L) against the
    reduced-system size (2·n/L)."""
    k = max(int(n - 1).bit_length(), 4)
    return 1 << (k // 2)


def _interior_fac(loi, dgi, upi):
    """LU factors of the block-interior tridiagonals (batched scan)."""
    loi = loi.at[0].set(0.0)
    upm1 = jnp.concatenate([jnp.zeros_like(upi[:1]), upi[:-1]], axis=0)

    def fac(d_prev, inp):
        a, lo_t, upm = inp
        l_t = lo_t / d_prev
        d_t = a - l_t * upm
        return d_t, (d_t, l_t)

    _, (ds, ls) = jax.lax.scan(
        fac, jnp.ones_like(dgi[0]), (dgi, loi, upm1)
    )
    return ls, 1.0 / ds


def _interior_solve(l, dinv, upi, r):
    """Solve the cached block-interior LU systems (two batched scans)."""

    def fwd(z_prev, inp):
        r_t, l_t = inp
        z = r_t - l_t * z_prev
        return z, z

    _, zs = jax.lax.scan(fwd, jnp.zeros_like(r[0]), (r, l))

    def bwd(x_next, inp):
        z_t, up_t, di_t = inp
        x = (z_t - up_t * x_next) * di_t
        return x, x

    _, xs = jax.lax.scan(
        bwd, jnp.zeros_like(r[0]), (zs, upi, dinv), reverse=True
    )
    return xs


def setup_lines_spike(so: jnp.ndarray, kind: StencilKind,
                      axis: str) -> SpikeLines:
    """Per-color SPIKE factors for the lines along ``axis``.

    The y variant factors the transposed operator so the factors are
    already in x-line layout (line_relax_y passes them through untouched).
    """
    if axis == "y":
        so = _transpose_so(so, kind)
    diag = so[Dir2.O]
    lo = -so[Dir2.W]
    up = _shift0(lo, 1, 0.0)
    return SpikeLines(
        even=_spike_setup(_cols(lo, 0), _cols(diag, 0), _cols(up, 0)),
        odd=_spike_setup(_cols(lo, 1), _cols(diag, 1), _cols(up, 1)),
    )


def _spike_setup(lo, dg, up) -> SpikeFactors:
    """Build SPIKE factors for one color.  ``lo/dg/up``: (n, nb) with
    lo[0] = up[n-1] = 0 (lo[i] couples row i to i-1)."""
    dg = jnp.where(dg == 0.0, 1.0, dg)   # _cols zero-pad column guard
    n, nb = dg.shape
    L = _spike_block_len(n)
    npad = -(-n // L) * L
    B = npad // L

    def blocks(a, fill):
        a = jnp.pad(a, ((0, npad - n), (0, 0)), constant_values=fill)
        return a.reshape(B, L, nb).transpose(1, 0, 2)   # (L, B, nb)

    lo3 = blocks(lo, 0.0)
    dg3 = blocks(dg, 1.0)
    up3 = blocks(up, 0.0)
    # padding must not couple into real rows
    up3 = up3.at[L - 1, B - 1].set(0.0)

    loi, dgi, upi = lo3[1:L - 1], dg3[1:L - 1], up3[1:L - 1]
    upi_z = upi.at[-1].set(0.0)       # coupling to row L-1 is a source
    l, dinv = _interior_fac(loi, dgi, upi_z)

    src_p = jnp.zeros_like(dgi).at[0].set(-loi[0])
    src_q = jnp.zeros_like(dgi).at[-1].set(-upi[-1])
    p = _interior_solve(l, dinv, upi_z, src_p)
    q = _interior_solve(l, dinv, upi_z, src_q)

    up0, loL = up3[0], lo3[L - 1]
    rdg_e = dg3[0] + up0 * p[0]
    rup_e = up0 * q[0]
    rlo_o = loL * p[-1]
    rdg_o = dg3[L - 1] + loL * q[-1]

    def ileave(a, b):
        return jnp.stack([a, b], axis=1).reshape(2 * B, nb)

    return SpikeFactors(
        l=l, dinv=dinv, upi=upi_z, p=p, q=q, up0=up0, loL=loL,
        rlo=ileave(lo3[0], rlo_o),
        rdg=ileave(rdg_e, rdg_o),
        rup=ileave(rup_e, up3[L - 1]),
    )


def _spike_solve(f: SpikeFactors, rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve the factored line systems for one color: (n, nb) -> (n, nb)."""
    n, nb = rhs.shape
    Li, B, _ = f.p.shape
    L = Li + 2
    npad = B * L
    r = jnp.pad(rhs, ((0, npad - n), (0, 0)))
    r3 = r.reshape(B, L, nb).transpose(1, 0, 2)

    phi = _interior_solve(f.l, f.dinv, f.upi, r3[1:L - 1])

    rr = jnp.stack(
        [r3[0] - f.up0 * phi[0], r3[L - 1] - f.loL * phi[-1]], axis=1
    ).reshape(2 * B, nb)
    w = _pcr_solve(f.rlo, f.rdg, f.rup, rr).reshape(B, 2, nb)
    s, e = w[:, 0], w[:, 1]

    x_int = phi + f.p * s[None] + f.q * e[None]
    x3 = jnp.concatenate([s[None], x_int, e[None]], axis=0)
    return x3.transpose(1, 0, 2).reshape(npad, nb)[:n]


# ---------------------------------------------------------------------------
# Distributed interface-reduction (SPIKE) line solves.
#
# The reference's distributed zebra algorithm (LineSolve_A/B/C,
# src/2d/ftn/mpi/BMG2_SymStd_relax_lines_x.f90:156-277) eliminates each
# rank's block interior, gathers 8 interface coefficients per line ONCE,
# solves the reduced tridiagonal on the line root, scatters, and
# back-substitutes.  This is the same SPIKE factorization as the serial
# cached path above with "block" = "shard": factors are built per shard at
# setup inside shard_map, the reduced (2·P)-row tridiagonal coefficients
# are all-gathered once at setup and stored replicated, and each solve does
# exactly ONE all_gather of (2, nb) interface rhs rows per color — vs the
# full-line gather of `_local_solve` (which moves the whole operand) or
# auto-SPMD PCR (collectives on every log2(n) step).
# ---------------------------------------------------------------------------


class DistSpikeFactors(NamedTuple):
    """Per-color distributed SPIKE workspace (global arrays on the mesh).

    With P shards along the line axis and local block length L:
    interior arrays are ((L-2)*P, nb) sharded along the line axis (each
    shard holds its own block's rows); ``up0/loL`` are (P, nb); the
    reduced-system rows ``rlo/rdg/rup`` are (2P, nb) replicated along the
    line axis (interleaved block-first/block-last, shard order).
    """
    l: jnp.ndarray
    dinv: jnp.ndarray
    upi: jnp.ndarray
    p: jnp.ndarray
    q: jnp.ndarray
    up0: jnp.ndarray
    loL: jnp.ndarray
    rlo: jnp.ndarray
    rdg: jnp.ndarray
    rup: jnp.ndarray


@jax.tree_util.register_pytree_node_class
class DistSpikeLines:
    """Per-color distributed SPIKE factors + static mesh metadata."""

    def __init__(self, even, odd, mesh, line_ax, batch_ax):
        self.even = even
        self.odd = odd
        self.mesh = mesh
        self.line_ax = line_ax
        self.batch_ax = batch_ax

    def __getitem__(self, parity):
        return self.odd if parity else self.even

    def tree_flatten(self):
        return (self.even, self.odd), (self.mesh, self.line_ax,
                                       self.batch_ax)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], *aux)


def dist_spike_eligible(shape, spec, mesh, periodic, axis: str):
    """Whether ``axis`` lines of a level with this sharding can run the
    distributed interface reduction (callers fall back to the
    line-axis-local gather otherwise)."""
    nx, ny = shape
    if axis == "y":
        nx, ny = ny, nx
        spec = (spec[1], spec[0])
        periodic = (periodic[1], periodic[0])
    la, ba = spec[0], spec[1]
    if la is None or mesh.shape[la] <= 1:
        return False
    if periodic[0]:               # cyclic line: Sherman–Morrison path
        return False
    pl_ = mesh.shape[la]
    if nx % pl_ or nx // pl_ < 4:
        return False
    if ba is not None:
        # each shard's column count must be even so the zebra parity
        # split/merge stay shard-local (no layout collectives)
        pb = mesh.shape[ba]
        if ny % (2 * pb):
            return False
    return True


def setup_lines_spike_dist(so, kind: StencilKind, axis: str, mesh,
                           line_ax, batch_ax) -> DistSpikeLines:
    """Build distributed SPIKE factors for the lines along ``axis``.

    ``line_ax``/``batch_ax`` are the mesh-axis names sharding the line
    and batch (cross-line) GRID axes of the (possibly transposed)
    operator.  Reference: MPI_BMG2_SymStd_SETUP_lines_{x,y} + the
    LineSolve_A elimination factors it caches.
    """
    from jax.sharding import PartitionSpec as _P

    if axis == "y":
        so = _transpose_so(so, kind)
    diag = so[Dir2.O]
    lo = -so[Dir2.W]
    up = _shift0(lo, 1, 0.0)     # one-time global shift (halo at setup)

    def local_setup(lo_l, dg_l, up_l):
        L = dg_l.shape[0]
        loi, dgi, upi = lo_l[1:L - 1], dg_l[1:L - 1], up_l[1:L - 1]
        upi_z = upi.at[-1].set(0.0)
        l, dinv = _interior_fac(loi, dgi, upi_z)
        src_p = jnp.zeros_like(dgi).at[0].set(-loi[0])
        src_q = jnp.zeros_like(dgi).at[-1].set(-upi[-1])
        p = _interior_solve(l, dinv, upi_z, src_p)
        q = _interior_solve(l, dinv, upi_z, src_q)
        up0, loL = up_l[0], lo_l[L - 1]
        red = jnp.stack([
            jnp.stack([lo_l[0], loL * p[-1]]),             # rlo pair
            jnp.stack([dg_l[0] + up0 * p[0],
                       dg_l[L - 1] + loL * q[-1]]),        # rdg pair
            jnp.stack([up0 * q[0], up_l[L - 1]]),          # rup pair
        ])                                                 # (3, 2, nb)
        redg = jax.lax.all_gather(red, line_ax)            # (P, 3, 2, nb)
        redg = redg.transpose(1, 0, 2, 3).reshape(3, -1, red.shape[-1])
        return (l, dinv, upi_z, p, q, up0[None], loL[None],
                redg[0], redg[1], redg[2])

    def one(parity):
        lo_c = _cols(lo, parity)
        dg_c = _cols(diag, parity)
        up_c = _cols(up, parity)
        dg_c = jnp.where(dg_c == 0.0, 1.0, dg_c)  # _cols zero-pad guard
        sh = _P(line_ax, batch_ax)
        rep = _P(None, batch_ax)
        outs = jax.shard_map(
            local_setup, mesh=mesh,
            in_specs=(sh, sh, sh),
            out_specs=(sh,) * 5 + (sh,) * 2 + (rep,) * 3,
            check_vma=False,
        )(lo_c, dg_c, up_c)
        return DistSpikeFactors(*outs)

    return DistSpikeLines(one(0), one(1), mesh, line_ax, batch_ax)


def _dist_spike_color(ws: DistSpikeLines, parity: int, so, q, b, kind,
                      periodic) -> jnp.ndarray:
    """One color of the distributed interface-reduction sweep.

    The rhs is formed globally (the SPMD partitioner's halo permutes for
    the cross-line shifts are the analogue of the reference's pre-sweep
    ghost update); the zebra parity split, block solve, and row merge all
    run shard-locally, so the ONLY solve collective is the single
    all_gather of the (2, nb) interface rhs (LineSolve_B's MPI_GATHER
    analogue).  The reduced (2P)-row tridiagonal is solved replicated
    (redundant solve — cheaper than root-solve + scatter between
    devices)."""
    from jax.sharding import PartitionSpec as _P

    rhs_full = _line_rhs_x(so, q, b, kind, periodic)
    f = ws[parity]
    la, ba = ws.line_ax, ws.batch_ax

    def local(l, dinv, upi, p, q_sp, up0, loL, rlo, rdg, rup, rf, q_loc):
        r = _split_axis(rf, 1)[parity]                    # shard-local
        L = r.shape[0]
        phi = _interior_solve(l, dinv, upi, r[1:L - 1])
        rr = jnp.stack([r[0] - up0[0] * phi[0],
                        r[L - 1] - loL[0] * phi[-1]])     # (2, nb)
        rr_all = jax.lax.all_gather(rr, la).reshape(-1, rr.shape[-1])
        w = _pcr_solve(rlo, rdg, rup, rr_all)             # (2P, nb)
        i = jax.lax.axis_index(la)
        se = jax.lax.dynamic_slice_in_dim(w, 2 * i, 2, 0)
        x_int = phi + p * se[0][None] + q_sp * se[1][None]
        sol = jnp.concatenate([se[:1], x_int, se[1:2]], axis=0)
        return _set_rows(q_loc, sol, parity)              # shard-local

    sh = _P(la, ba)
    rep = _P(None, ba)
    return jax.shard_map(
        local, mesh=ws.mesh,
        in_specs=(sh,) * 5 + (sh,) * 2 + (rep,) * 3 + (sh, sh),
        out_specs=sh,
        check_vma=False,
    )(f.l, f.dinv, f.upi, f.p, f.q, f.up0, f.loL, f.rlo, f.rdg, f.rup,
      rhs_full, q)


def _local_solve(solve, nargs, shard):
    """Wrap a batched tridiagonal solve so the LINE axis is solved locally.

    Under auto-SPMD with the line axis sharded, the partitioner inserts a
    collective on every PCR reduction step (measured: 2,348 collectives
    for one zebra sweep at 512² sharded 4-way — tools/analyze_lines.py).
    The reference instead gathers once per color via its interface
    reduction (src/2d/ftn/mpi/BMG2_SymStd_relax_lines_x.f90:156-277).
    Equivalent here: shard_map with the line axis replicated — shard_map's
    input reshard is the ONE all-gather, the solve is local, and the
    output reshard restores the level's sharding."""
    if shard is None:
        return solve
    spec = list(shard.spec) + [None]
    line_ax, batch_ax = spec[0], spec[1]
    if line_ax is None or shard.mesh.shape[line_ax] <= 1:
        return solve
    del nargs

    def wrapped(*args):
        n_batch = args[-1].shape[-1]
        if (batch_ax is not None
                and n_batch % shard.mesh.shape[batch_ax] != 0):
            return solve(*args)

        def spec_of(a):
            # trailing (line, batch) dims; leading dims replicated
            return jax.sharding.PartitionSpec(
                *([None] * (a.ndim - 1)), batch_ax
            )

        return jax.shard_map(
            solve, mesh=shard.mesh,
            in_specs=tuple(spec_of(a) for a in args),
            out_specs=jax.sharding.PartitionSpec(None, batch_ax),
            check_vma=False,
        )(*args)

    return wrapped


def _tridiag_solve(sor: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve LDLᵀ x = rhs along axis 0, batched over axis 1."""
    dinv, l = sor[0], sor[1]

    def fwd(z_prev, inputs):
        b_i, l_i = inputs
        z_i = b_i - l_i * z_prev
        return z_i, z_i

    z0 = rhs[0]
    _, zs = jax.lax.scan(fwd, z0, (rhs[1:], l[1:]))
    z = jnp.concatenate([z0[None], zs], axis=0)
    w = z * dinv

    def bwd(x_next, inputs):
        w_i, l_next = inputs
        x_i = w_i - l_next * x_next
        return x_i, x_i

    xn = w[-1]
    _, xs = jax.lax.scan(
        bwd, xn, (w[:-1][::-1], l[1:][::-1])
    )
    return jnp.concatenate([xs[::-1], xn[None]], axis=0)


def _transpose_so(so: jnp.ndarray, kind: StencilKind) -> jnp.ndarray:
    ot = so[Dir2.O].T
    wt = so[Dir2.S].T
    st = so[Dir2.W].T
    if kind == StencilKind.five_pt:
        return jnp.stack([ot, wt, st])
    return jnp.stack([ot, wt, st, so[Dir2.SW].T, so[Dir2.NW].T])


def _line_rhs_x(so, q, b, kind, periodic):
    """rhs = b + couplings to neighboring ROWS (everything but W/E terms)."""
    S = so[Dir2.S]
    rhs = (
        b
        + S * shift2(q, 0, -1, periodic)
        + shift2(S, 0, 1, periodic) * shift2(q, 0, 1, periodic)
    )
    if kind != StencilKind.five_pt:
        SW, NW = so[Dir2.SW], so[Dir2.NW]
        rhs = (
            rhs
            + SW * shift2(q, -1, -1, periodic)
            + shift2(NW, 1, 0, periodic) * shift2(q, 1, -1, periodic)
            + shift2(NW, 0, 1, periodic) * shift2(q, -1, 1, periodic)
            + shift2(SW, 1, 1, periodic) * shift2(q, 1, 1, periodic)
        )
    return rhs


def _set_rows(q: jnp.ndarray, rows: jnp.ndarray, parity: int) -> jnp.ndarray:
    """Replace rows (along axis 1) of the given parity, scatter-free."""
    nx, ny = q.shape
    n_even = (ny + 1) // 2
    n_odd = ny // 2
    m = max(n_even, n_odd)
    if parity == 0:
        even, odd = rows, _cols(q, 1)
    else:
        even, odd = _cols(q, 0), rows
    even = jnp.pad(even, ((0, 0), (0, m - even.shape[1])))
    odd = jnp.pad(odd, ((0, 0), (0, m - odd.shape[1])))
    out = jnp.stack([even, odd], axis=2).reshape(nx, 2 * m)
    return out[:, :ny]


def line_relax_x(
    so: jnp.ndarray,
    q: jnp.ndarray,
    b: jnp.ndarray,
    sor: jnp.ndarray,
    kind: StencilKind,
    updown: str,
    periodic=(False, False),
    shard=None,
) -> jnp.ndarray:
    """One zebra x-line sweep (both colors).

    ``shard``: the operand's NamedSharding when running distributed; the
    tridiagonal solves then run line-axis-local via :func:`_local_solve`
    (one gather per color, the analogue of the reference's interface
    reduction)."""
    if periodic[1] and q.shape[1] % 2:
        raise ValueError(
            "zebra x-line relaxation needs an even number of lines when the "
            "y axis is periodic (line 0 and line ny-1 are neighbors)"
        )
    order = (1, 0) if updown == "down" else (0, 1)
    cyclic = bool(periodic[0])   # wrap coupling along the line itself

    if isinstance(sor, SpikeLines) and shard is None and not cyclic:
        # cached interface reduction: one pass over the operands per color
        for parity in order:
            rhs = _cols(_line_rhs_x(so, q, b, kind, periodic), parity)
            sol = _spike_solve(sor[parity], rhs)
            q = _set_rows(q, sol, parity)
        return q

    if isinstance(sor, DistSpikeLines) and not cyclic:
        # distributed interface reduction: one interface all_gather per
        # color (reference: LineSolve_A/B/C one-gather scheme)
        for parity in order:
            q = _dist_spike_color(sor, parity, so, q, b, kind, periodic)
        return q

    use_pcr = q.shape[0] >= _PCR_MIN_LEN or isinstance(sor, SpikeLines)
    if use_pcr or cyclic:
        diag = so[Dir2.O]
        lo = -so[Dir2.W]
        if cyclic:
            up = jnp.roll(lo, -1, axis=0)   # up[n-1] = wrap coupling lo[0]
        else:
            up = _shift0(lo, 1, 0.0)
    csolve = _local_solve(_cyclic_solve, 4, shard)
    psolve = _local_solve(_pcr_solve, 4, shard)
    tsolve = _local_solve(_tridiag_solve, 2, shard)
    for parity in order:
        rhs = _cols(_line_rhs_x(so, q, b, kind, periodic), parity)
        if cyclic:
            sol = csolve(
                _cols(lo, parity), _cols(diag, parity), _cols(up, parity),
                rhs,
            )
        elif use_pcr:
            sol = psolve(
                _cols(lo, parity), _cols(diag, parity), _cols(up, parity),
                rhs,
            )
        else:
            sol = tsolve(_cols(sor, parity), rhs)
        q = _set_rows(q, sol, parity)
    return q


def line_relax_y(
    so: jnp.ndarray,
    q: jnp.ndarray,
    b: jnp.ndarray,
    sor: jnp.ndarray,
    kind: StencilKind,
    updown: str,
    periodic=(False, False),
    shard=None,
) -> jnp.ndarray:
    """One zebra y-line sweep: x-line relaxation of the transposed system."""
    so_t = _transpose_so(so, kind)
    per_t = (periodic[1], periodic[0])
    shard_t = None
    if shard is not None:
        spec = list(shard.spec) + [None, None]
        shard_t = jax.sharding.NamedSharding(
            shard.mesh, jax.sharding.PartitionSpec(spec[1], spec[0])
        )
    sor_t = (sor if isinstance(sor, (SpikeLines, DistSpikeLines))
             else sor.transpose(0, 2, 1))
    qt = line_relax_x(
        so_t, q.T, b.T, sor_t, kind, updown, per_t,
        shard_t,
    )
    return qt.T
