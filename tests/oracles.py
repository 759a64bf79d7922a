"""Literal numpy transcriptions of the reference Fortran kernels (2D).

These are the independent test oracles (the role pyamg/Cython oracles play in
the reference's test suite, SURVEY §4): sequential loops over ghost-padded
1-based-style arrays, transcribed statement-by-statement from
the reference's src/2d/ftn/*.f90 so that any deviation of the vectorized
kernels from the reference semantics is caught exactly.

Array convention here matches the Fortran: ghost-padded, shape (II, JJ) with
interior 1..II-2 (0-based), i.e. Fortran index I corresponds to numpy index
I-1.  Helpers convert to/from the framework's interior-only arrays.

Stencil plane order: [KO, KW, KS, KSW, KNW] (2D), CI planes
[LL, LR, LA, LB, LSW, LNW, LNE, LSE] — the framework's order.
"""

from __future__ import annotations

import numpy as np

KO, KW, KS, KSW, KNW = 0, 1, 2, 3, 4
LL, LR, LA, LB, LSW, LNW, LNE, LSE = 0, 1, 2, 3, 4, 5, 6, 7


# -- conversions -------------------------------------------------------------

def pad_ghost(interior: np.ndarray) -> np.ndarray:
    """interior (nx, ny) -> ghosted (nx+2, ny+2); zero ghosts."""
    return np.pad(interior, ((1, 1), (1, 1)))


def pad_ghost_so(so_interior: np.ndarray) -> np.ndarray:
    """(ndir, nx, ny) -> (ndir, nx+2, ny+2), 5 planes always."""
    ndir = so_interior.shape[0]
    out = np.zeros((5, so_interior.shape[1] + 2, so_interior.shape[2] + 2))
    for d in range(ndir):
        out[d, 1:-1, 1:-1] = so_interior[d]
    return out


def unpad(g: np.ndarray) -> np.ndarray:
    return g[1:-1, 1:-1]


# -- relaxation (BMG2_SymStd_relax_GS.f90, non-periodic) ----------------------

def relax_gs(so, q, qf, sor, nstncl, updown):
    """so/q/qf/sor ghosted; nstncl 3 (5-pt) or 5 (9-pt); updown 'down'/'up'.

    Transcribed from BMG2_SymStd_relax_GS.f90:78-137 (IRELAX_SYM == SYM).
    Fortran index F -> numpy index F-1.
    """
    II, JJ = q.shape
    J1, I1 = JJ - 1, II - 1
    q = q.copy()
    if updown == "down":
        lrange = [2, 3]
    else:
        lrange = [3, 2]

    def S(i, j, d):  # Fortran-style accessor
        return so[d, i - 1, j - 1]

    if nstncl == 5:
        for jbeg in lrange:
            jend = 2 * ((J1 - jbeg) // 2) + jbeg
            for j in range(jbeg, jend + 1, 2):
                for ibeg in lrange:
                    iend = 2 * ((I1 - ibeg) // 2) + ibeg
                    for i in range(ibeg, iend + 1, 2):
                        q[i - 1, j - 1] = (
                            qf[i - 1, j - 1]
                            + S(i, j, KW) * q[i - 2, j - 1]
                            + S(i + 1, j, KW) * q[i, j - 1]
                            + S(i, j, KS) * q[i - 1, j - 2]
                            + S(i, j + 1, KS) * q[i - 1, j]
                            + S(i, j, KSW) * q[i - 2, j - 2]
                            + S(i + 1, j, KNW) * q[i, j - 2]
                            + S(i, j + 1, KNW) * q[i - 2, j]
                            + S(i + 1, j + 1, KSW) * q[i, j]
                        ) * sor[i - 1, j - 1]
    else:
        for jo in lrange:
            for j in range(2, J1 + 1):
                ibeg = (j + jo) % 2 + 2
                iend = 2 * ((I1 - ibeg) // 2) + ibeg
                for i in range(ibeg, iend + 1, 2):
                    q[i - 1, j - 1] = (
                        qf[i - 1, j - 1]
                        + S(i, j, KW) * q[i - 2, j - 1]
                        + S(i + 1, j, KW) * q[i, j - 1]
                        + S(i, j, KS) * q[i - 1, j - 2]
                        + S(i, j + 1, KS) * q[i - 1, j]
                    ) * sor[i - 1, j - 1]
    return q


# -- interpolation setup (BMG2_SymStd_SETUP_interp_OI.f90, non-periodic) ------

def setup_interp_oi(so, iif, jjf, iic, jjc, ifd):
    """Literal transcription of the non-periodic branch (:84-256).

    so: ghosted (5, IIF, JJF).  Returns CI ghosted (8, IIC, JJC).
    ifd=1 means five-point.
    """
    ci = np.zeros((8, iic, jjc))
    zeps = np.finfo(np.float64).eps

    def S(i, j, d):
        return so[d, i - 1, j - 1]

    def setC(d, i, j, v):
        ci[d, i - 1, j - 1] = v

    def C(d, i, j):
        return ci[d, i - 1, j - 1]

    iic1, jjc1 = iic - 1, jjc - 1
    iicf = (iif - 2) // 2 + 3
    jjcf = (jjf - 2) // 2 + 3
    iicf1, jjcf1 = iicf - 1, jjcf - 1

    if ifd != 1:
        # nine point
        j = 0
        for jc in range(2, jjc1 + 1):
            j += 2
            i = 2
            for ic in range(3, iicf1 + 1):
                i += 2
                a = S(i, j, KW) + S(i, j, KNW) + S(i, j + 1, KSW)
                b = S(i - 1, j, KW) + S(i - 1, j, KSW) + S(i - 1, j + 1, KNW)
                ep = min(abs(a / S(i - 1, j, KO)), abs(b / S(i - 1, j, KO)))
                som = a + b + S(i - 1, j, KS) + S(i - 1, j + 1, KS)
                som = a + b + (S(i - 1, j, KO) - som) * max(
                    S(i - 1, j, KO) - (1 + ep) * som, 0.0
                ) / (abs(S(i - 1, j, KO) - (1 + ep) * som) + zeps)
                som = 1.0 / som
                setC(LR, ic, jc, a * som)
                setC(LL, ic, jc, b * som)
        j = 2
        for jc in range(3, jjcf1 + 1):
            j += 2
            i = 0
            for ic in range(2, iic1 + 1):
                i += 2
                a = S(i, j, KS) + S(i, j, KNW) + S(i + 1, j, KSW)
                b = S(i, j - 1, KS) + S(i, j - 1, KSW) + S(i + 1, j - 1, KNW)
                ep = min(abs(a / S(i, j - 1, KO)), abs(b / S(i, j - 1, KO)))
                som = a + b + S(i, j - 1, KW) + S(i + 1, j - 1, KW)
                som = a + b + (S(i, j - 1, KO) - som) * max(
                    S(i, j - 1, KO) - (1 + ep) * som, 0.0
                ) / (abs(S(i, j - 1, KO) - (1 + ep) * som) + zeps)
                som = 1.0 / som
                setC(LA, ic, jc, a * som)
                setC(LB, ic, jc, b * som)
        j = 2
        for jc in range(3, jjcf1 + 1):
            j += 2
            i = 2
            for ic in range(3, iicf1 + 1):
                i += 2
                som = (
                    S(i - 1, j - 1, KW)
                    + S(i - 1, j, KNW)
                    + S(i - 1, j, KS)
                    + S(i, j, KSW)
                    + S(i, j - 1, KW)
                    + S(i, j - 1, KNW)
                    + S(i - 1, j - 1, KS)
                    + S(i - 1, j - 1, KSW)
                )
                co = S(i - 1, j - 1, KO)
                ep = min(
                    abs((S(i - 1, j - 1, KSW) + S(i - 1, j - 1, KW)
                         + S(i - 1, j, KNW)) / co),
                    abs((S(i - 1, j, KNW) + S(i - 1, j, KS)
                         + S(i, j, KSW)) / co),
                    abs((S(i, j, KSW) + S(i, j - 1, KW)
                         + S(i, j - 1, KNW)) / co),
                    abs((S(i, j - 1, KNW) + S(i - 1, j - 1, KS)
                         + S(i - 1, j - 1, KSW)) / co),
                )
                som = som + (co - som) * max(co - (1 + ep) * som, 0.0) / (
                    abs(co - (1 + ep) * som) + zeps
                )
                s = 1.0 / som
                setC(LSW, ic, jc,
                     (S(i - 1, j - 1, KS) * C(LL, ic, jc - 1)
                      + S(i - 1, j - 1, KW) * C(LB, ic - 1, jc)
                      + S(i - 1, j - 1, KSW)) * s)
                setC(LSE, ic, jc,
                     (S(i - 1, j - 1, KS) * C(LR, ic, jc - 1)
                      + S(i, j - 1, KW) * C(LB, ic, jc)
                      + S(i, j - 1, KNW)) * s)
                setC(LNW, ic, jc,
                     (S(i - 1, j - 1, KW) * C(LA, ic - 1, jc)
                      + S(i - 1, j, KS) * C(LL, ic, jc)
                      + S(i - 1, j, KNW)) * s)
                setC(LNE, ic, jc,
                     (S(i - 1, j, KS) * C(LR, ic, jc)
                      + S(i, j - 1, KW) * C(LA, ic, jc)
                      + S(i, j, KSW)) * s)
    else:
        # five point
        j = 0
        for jc in range(2, jjc1 + 1):
            j += 2
            i = 2
            for ic in range(3, iicf1 + 1):
                i += 2
                a = S(i, j, KW)
                b = S(i - 1, j, KW)
                ep = min(abs(a / S(i - 1, j, KO)), abs(b / S(i - 1, j, KO)))
                som = a + b + S(i - 1, j, KS) + S(i - 1, j + 1, KS)
                som = a + b + (S(i - 1, j, KO) - som) * max(
                    S(i - 1, j, KO) - (1 + ep) * som, 0.0
                ) / (abs(S(i - 1, j, KO) - (1 + ep) * som) + zeps)
                som = 1.0 / som
                setC(LR, ic, jc, a * som)
                setC(LL, ic, jc, b * som)
        j = 2
        for jc in range(3, jjcf1 + 1):
            j += 2
            i = 0
            for ic in range(2, iic1 + 1):
                i += 2
                a = S(i, j, KS)
                b = S(i, j - 1, KS)
                ep = min(abs(a / S(i, j - 1, KO)), abs(b / S(i, j - 1, KO)))
                som = a + b + S(i, j - 1, KW) + S(i + 1, j - 1, KW)
                som = a + b + (S(i, j - 1, KO) - som) * max(
                    S(i, j - 1, KO) - (1 + ep) * som, 0.0
                ) / (abs(S(i, j - 1, KO) - (1 + ep) * som) + zeps)
                som = 1.0 / som
                setC(LA, ic, jc, a * som)
                setC(LB, ic, jc, b * som)
        j = 2
        for jc in range(3, jjcf1 + 1):
            j += 2
            i = 2
            for ic in range(3, iicf1 + 1):
                i += 2
                som = (S(i - 1, j - 1, KW) + S(i - 1, j, KS)
                       + S(i, j - 1, KW) + S(i - 1, j - 1, KS))
                co = S(i - 1, j - 1, KO)
                ep = min(
                    abs(S(i - 1, j - 1, KW) / co),
                    abs(S(i - 1, j, KS) / co),
                    abs(S(i, j - 1, KW) / co),
                    abs(S(i - 1, j - 1, KS) / co),
                )
                som = som + (co - som) * max(co - (1 + ep) * som, 0.0) / (
                    abs(co - (1 + ep) * som) + zeps
                )
                s = 1.0 / som
                setC(LSW, ic, jc,
                     (S(i - 1, j - 1, KS) * C(LL, ic, jc - 1)
                      + S(i - 1, j - 1, KW) * C(LB, ic - 1, jc)) * s)
                setC(LSE, ic, jc,
                     (S(i - 1, j - 1, KS) * C(LR, ic, jc - 1)
                      + S(i, j - 1, KW) * C(LB, ic, jc)) * s)
                setC(LNW, ic, jc,
                     (S(i - 1, j - 1, KW) * C(LA, ic - 1, jc)
                      + S(i - 1, j, KS) * C(LL, ic, jc)) * s)
                setC(LNE, ic, jc,
                     (S(i - 1, j, KS) * C(LR, ic, jc)
                      + S(i, j - 1, KW) * C(LA, ic, jc)) * s)
    return ci


# -- restriction (BMG2_SymStd_restrict.f90:76-92) -----------------------------

def restrict(ci, q, nxc, nyc):
    """ci ghosted (8, IIC, JJC); q ghosted fine.  Returns ghosted coarse."""
    qc = np.zeros((nxc, nyc))

    def C(d, i, j):
        return ci[d, i - 1, j - 1]

    def Q(i, j):
        return q[i - 1, j - 1]

    j = 0
    for jc in range(2, nyc - 1 + 1):
        j += 2
        i = 0
        for ic in range(2, nxc - 1 + 1):
            i += 2
            qc[ic - 1, jc - 1] = (
                C(LNE, ic, jc) * Q(i - 1, j - 1)
                + C(LA, ic, jc) * Q(i, j - 1)
                + C(LNW, ic + 1, jc) * Q(i + 1, j - 1)
                + C(LR, ic, jc) * Q(i - 1, j)
                + Q(i, j)
                + C(LL, ic + 1, jc) * Q(i + 1, j)
                + C(LSE, ic, jc + 1) * Q(i - 1, j + 1)
                + C(LB, ic, jc + 1) * Q(i, j + 1)
                + C(LSW, ic + 1, jc + 1) * Q(i + 1, j + 1)
            )
    return qc


# -- interpolate + add (BMG2_SymStd_interp_add.f90:101-137) -------------------

def interp_add(ci, so_f, q, qc, res, iif, jjf, iic, jjc):
    """All arrays ghosted.  Returns updated fine q.  NStncl irrelevant
    (only KO is read)."""
    q = q.copy()
    res = res.copy()
    iicf = (iif - 2) // 2 + 3
    jjcf = (jjf - 2) // 2 + 3
    iicf1, jjcf1 = iicf - 1, jjcf - 1

    def C(d, i, j):
        return ci[d, i - 1, j - 1]

    for j in range(2, jjf - 1 + 1):
        for i in range(2, iif - 1 + 1):
            res[i - 1, j - 1] /= so_f[KO, i - 1, j - 1]

    j = 2
    i = 2
    q[1, 1] += qc[1, 1]
    for ic in range(3, iicf1 + 1):
        i += 2
        if i - 1 < iif:  # guard ghost write (harmless in Fortran)
            q[i - 1, j - 1] += qc[ic - 1, 1] if ic - 1 < iic else 0.0
        a = C(LR, ic, 2) * qc[ic - 1, 1] + C(LL, ic, 2) * qc[ic - 2, 1]
        q[i - 2, j - 1] += a + res[i - 2, j - 1]
    for jc in range(3, jjcf1 + 1):
        j += 2
        i = 2
        if j - 1 < jjf:
            q[1, j - 1] += qc[1, jc - 1] if jc - 1 < jjc else 0.0
        aq = C(LA, 2, jc) * qc[1, jc - 1] + C(LB, 2, jc) * qc[1, jc - 2]
        q[1, j - 2] += aq + res[1, j - 2]
        for ic in range(3, iicf1 + 1):
            i += 2
            if i - 1 < iif and j - 1 < jjf:
                q[i - 1, j - 1] += (
                    qc[ic - 1, jc - 1] if (ic - 1 < iic and jc - 1 < jjc) else 0.0
                )
            a = C(LR, ic, jc) * qc[ic - 1, jc - 1] + C(LL, ic, jc) * qc[ic - 2, jc - 1]
            q[i - 2, j - 1] += a + res[i - 2, j - 1]
            aq = C(LA, ic, jc) * qc[ic - 1, jc - 1] + C(LB, ic, jc) * qc[ic - 1, jc - 2]
            q[i - 1, j - 2] += aq + res[i - 1, j - 2]
            a = (C(LSW, ic, jc) * qc[ic - 2, jc - 2]
                 + C(LNW, ic, jc) * qc[ic - 2, jc - 1]
                 + C(LNE, ic, jc) * qc[ic - 1, jc - 1]
                 + C(LSE, ic, jc) * qc[ic - 1, jc - 2])
            q[i - 2, j - 2] += a + res[i - 2, j - 2]
    return q
