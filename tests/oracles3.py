"""Literal numpy transcriptions of the reference Fortran kernels (3D).

Independent test oracles for the 3D kernel stack, transcribed
statement-by-statement from the reference's src/3d/ftn/*.f90 (non-periodic
branches), in the same style as tests/oracles.py.

Arrays are ghost-padded, Fortran index I -> numpy index I-1.  Stencil plane
order matches the framework ([P, PW, PS, B, PSW, PNW, BW, BNW, BN, BNE, BE,
BSE, BS, BSW]); CI planes are the reference's 26 l* constants minus one.

One documented deviation: the reference's 27-point interior-point guard has
two apparent typos (BMG3_SymStd_SETUP_interp_OI.f90: the north/bottom face
sums at :426-431 and :437-446 are not divided by the diagonal, and the south
face sum at :432-436 reads kbse(i,j-1,k-1) twice in place of kbsw(G)); this
transcription uses the consistent normalization of its own seven-point branch
(:744-767), which the framework also implements.  The guard value only
matters when the indefiniteness gate sits exactly at threshold — never for
the diagonally-dominant operators tested.
"""

from __future__ import annotations

import numpy as np

KP, KPW, KPS, KB, KPSW, KPNW = 0, 1, 2, 3, 4, 5
KBW, KBNW, KBN, KBNE, KBE, KBSE, KBS, KBSW = 6, 7, 8, 9, 10, 11, 12, 13

(LXYL, LXYR, LXYA, LXYB, LXZA, LXZB,
 LXYNE, LXYSE, LXYSW, LXYNW,
 LXZSW, LXZNW, LXZNE, LXZSE,
 LYZSW, LYZNW, LYZNE, LYZSE,
 LBSW, LBNW, LBNE, LBSE,
 LTSW, LTNW, LTNE, LTSE) = range(26)


def pad_ghost(interior: np.ndarray) -> np.ndarray:
    return np.pad(interior, ((1, 1), (1, 1), (1, 1)))


def pad_ghost_so(so_interior: np.ndarray) -> np.ndarray:
    """(ndir, nx, ny, nz) -> (14, nx+2, ny+2, nz+2); missing planes zero."""
    out = np.zeros(
        (
            14,
            so_interior.shape[1] + 2,
            so_interior.shape[2] + 2,
            so_interior.shape[3] + 2,
        )
    )
    for d in range(so_interior.shape[0]):
        out[d, 1:-1, 1:-1, 1:-1] = so_interior[d]
    return out


def unpad(g: np.ndarray) -> np.ndarray:
    return g[1:-1, 1:-1, 1:-1]


# -- relaxation (BMG3_SymStd_relax_GS.f90:85-187, non-periodic) ---------------

def relax_gs(so, q, qf, sor, nstncl, updown):
    """so/q/qf/sor ghosted; nstncl 14 (27-pt) or 4 (7-pt)."""
    II, JJ, KK = q.shape
    I1, J1, K1 = II - 1, JJ - 1, KK - 1
    q = q.copy()

    def S(i, j, k, d):
        return so[d, i - 1, j - 1, k - 1]

    def idx(i, j, k):
        return (i - 1, j - 1, k - 1)

    if nstncl == 14:
        if updown == "up":
            pts_range = range(1, 9)
        else:
            pts_range = range(8, 0, -1)
        for pts in pts_range:
            for k in range(2 + ((pts - 1) // 4) % 2, K1 + 1, 2):
                for j in range(2 + ((pts - 1) // 2) % 2, J1 + 1, 2):
                    for i in range(2 + (pts - 1) % 2, I1 + 1, 2):
                        q[idx(i, j, k)] = (
                            qf[idx(i, j, k)]
                            + S(i, j, k, KPW) * q[idx(i - 1, j, k)]
                            + S(i, j + 1, k, KPNW) * q[idx(i - 1, j + 1, k)]
                            + S(i, j + 1, k, KPS) * q[idx(i, j + 1, k)]
                            + S(i + 1, j + 1, k, KPSW) * q[idx(i + 1, j + 1, k)]
                            + S(i + 1, j, k, KPW) * q[idx(i + 1, j, k)]
                            + S(i + 1, j, k, KPNW) * q[idx(i + 1, j - 1, k)]
                            + S(i, j, k, KPS) * q[idx(i, j - 1, k)]
                            + S(i, j, k, KPSW) * q[idx(i - 1, j - 1, k)]
                            + S(i, j, k, KB) * q[idx(i, j, k - 1)]
                            + S(i, j, k, KBW) * q[idx(i - 1, j, k - 1)]
                            + S(i, j + 1, k, KBNW) * q[idx(i - 1, j + 1, k - 1)]
                            + S(i, j + 1, k, KBN) * q[idx(i, j + 1, k - 1)]
                            + S(i + 1, j + 1, k, KBNE) * q[idx(i + 1, j + 1, k - 1)]
                            + S(i + 1, j, k, KBE) * q[idx(i + 1, j, k - 1)]
                            + S(i + 1, j, k, KBSE) * q[idx(i + 1, j - 1, k - 1)]
                            + S(i, j, k, KBS) * q[idx(i, j - 1, k - 1)]
                            + S(i, j, k, KBSW) * q[idx(i - 1, j - 1, k - 1)]
                            + S(i, j, k + 1, KB) * q[idx(i, j, k + 1)]
                            + S(i, j, k + 1, KBE) * q[idx(i - 1, j, k + 1)]
                            + S(i, j + 1, k + 1, KBSE) * q[idx(i - 1, j + 1, k + 1)]
                            + S(i, j + 1, k + 1, KBS) * q[idx(i, j + 1, k + 1)]
                            + S(i + 1, j + 1, k + 1, KBSW) * q[idx(i + 1, j + 1, k + 1)]
                            + S(i + 1, j, k + 1, KBW) * q[idx(i + 1, j, k + 1)]
                            + S(i + 1, j, k + 1, KBNW) * q[idx(i + 1, j - 1, k + 1)]
                            + S(i, j, k + 1, KBN) * q[idx(i, j - 1, k + 1)]
                            + S(i, j, k + 1, KBNE) * q[idx(i - 1, j - 1, k + 1)]
                        ) * sor[idx(i, j, k)]
    else:
        pts_range = (0, 1) if updown == "up" else (1, 0)
        for pts in pts_range:
            for k in range(2, K1 + 1):
                for j in range(2, J1 + 1):
                    ibeg = (j + k + pts) % 2 + 2
                    iend = 2 * ((I1 - ibeg) // 2) + ibeg
                    for i in range(ibeg, iend + 1, 2):
                        q[idx(i, j, k)] = (
                            qf[idx(i, j, k)]
                            + S(i, j, k, KPW) * q[idx(i - 1, j, k)]
                            + S(i, j + 1, k, KPS) * q[idx(i, j + 1, k)]
                            + S(i + 1, j, k, KPW) * q[idx(i + 1, j, k)]
                            + S(i, j, k, KPS) * q[idx(i, j - 1, k)]
                            + S(i, j, k, KB) * q[idx(i, j, k - 1)]
                            + S(i, j, k + 1, KB) * q[idx(i, j, k + 1)]
                        ) * sor[idx(i, j, k)]
    return q


# -- interpolation setup (BMG3_SymStd_SETUP_interp_OI.f90:89-536, 27-pt) ------

def setup_interp_oi(so, iif, jjf, kkf, iic, jjc, kkc):
    """27-point non-periodic branch.  so ghosted (14, IIF, JJF, KKF).
    Returns CI ghosted (26, IIC, JJC, KKC)."""
    ci = np.zeros((26, iic, jjc, kkc))
    eps = np.finfo(np.float64).eps

    def S(i, j, k, d):
        return so[d, i - 1, j - 1, k - 1]

    def C(d, i, j, k):
        return ci[d, i - 1, j - 1, k - 1]

    def setC(d, i, j, k, v):
        ci[d, i - 1, j - 1, k - 1] = v

    iic1, jjc1, kkc1 = iic - 1, jjc - 1, kkc - 1
    iicf = (iif - 2) // 2 + 3
    jjcf = (jjf - 2) // 2 + 3
    kkcf = (kkf - 2) // 2 + 3
    iicf1, jjcf1, kkcf1 = iicf - 1, jjcf - 1, kkcf - 1

    def guard(p, ab, ctot, ep):
        d = p - (1.0 + ep) * ctot
        return ab + (p - ctot) * max(d, 0.0) / (abs(d) + eps)

    # fine points on CF k-planes on fine-only x-lines (lxyl/lxyr, :127-161)
    k = 0
    for kc in range(2, kkc1 + 1):
        k += 2
        j = 0
        for jc in range(2, jjc1 + 1):
            j += 2
            i = 2
            for ic in range(3, iicf1 + 1):
                i += 2
                a = (S(i - 1, j + 1, k, KPNW) + S(i - 1, j, k, KPW)
                     + S(i - 1, j, k, KPSW)
                     + S(i - 1, j + 1, k, KBNW) + S(i - 1, j, k, KBW)
                     + S(i - 1, j, k, KBSW) + S(i - 1, j + 1, k + 1, KBSE)
                     + S(i - 1, j, k + 1, KBE) + S(i - 1, j, k + 1, KBNE))
                b = (S(i, j + 1, k, KPSW) + S(i, j, k, KPW)
                     + S(i, j, k, KPNW)
                     + S(i, j + 1, k, KBNE) + S(i, j, k, KBE)
                     + S(i, j, k, KBSE) + S(i, j + 1, k + 1, KBSW)
                     + S(i, j, k + 1, KBW) + S(i, j, k + 1, KBNW))
                c = (a + b + S(i - 1, j, k, KPS) + S(i - 1, j + 1, k, KPS)
                     + S(i - 1, j + 1, k, KBN) + S(i - 1, j, k, KB)
                     + S(i - 1, j, k, KBS)
                     + S(i - 1, j + 1, k + 1, KBS) + S(i - 1, j, k + 1, KB)
                     + S(i - 1, j, k + 1, KBN))
                p = S(i - 1, j, k, KP)
                ep = min(abs(a / p), abs(b / p))
                c = guard(p, a + b, c, ep)
                setC(LXYL, ic, jc, kc, a / c)
                setC(LXYR, ic, jc, kc, b / c)

    # fine points on CF k-planes on fine-only y-lines (lxya/lxyb, :163-197)
    k = 0
    for kc in range(2, kkc1 + 1):
        k += 2
        j = 2
        for jc in range(3, jjcf1 + 1):
            j += 2
            i = 0
            for ic in range(2, iic1 + 1):
                i += 2
                a = (S(i, j, k, KPNW) + S(i, j, k, KPS) + S(i + 1, j, k, KPSW)
                     + S(i, j, k, KBNW) + S(i, j, k, KBN) + S(i + 1, j, k, KBNE)
                     + S(i, j, k + 1, KBSE) + S(i, j, k + 1, KBS)
                     + S(i + 1, j, k + 1, KBSW))
                b = (S(i, j - 1, k, KPSW) + S(i, j - 1, k, KPS)
                     + S(i + 1, j - 1, k, KPNW)
                     + S(i, j - 1, k, KBSW) + S(i, j - 1, k, KBS)
                     + S(i + 1, j - 1, k, KBSE) + S(i, j - 1, k + 1, KBNE)
                     + S(i, j - 1, k + 1, KBN) + S(i + 1, j - 1, k + 1, KBNW))
                p = S(i, j - 1, k, KP)
                ep = min(abs(a / p), abs(b / p))
                c = (a + b + S(i, j - 1, k, KPW) + S(i + 1, j - 1, k, KPW)
                     + S(i, j - 1, k, KBW) + S(i, j - 1, k, KB)
                     + S(i + 1, j - 1, k, KBE)
                     + S(i, j - 1, k + 1, KBE) + S(i, j - 1, k + 1, KB)
                     + S(i + 1, j - 1, k + 1, KBW))
                c = guard(p, a + b, c, ep)
                setC(LXYA, ic, jc, kc, a / c)
                setC(LXYB, ic, jc, kc, b / c)

    # fine points on CF j-planes on fine-only z-lines (lxza/lxzb, :199-232)
    k = 2
    for kc in range(3, kkcf1 + 1):
        k += 2
        j = 0
        for jc in range(2, jjc1 + 1):
            j += 2
            i = 0
            for ic in range(2, iic1 + 1):
                i += 2
                a = (S(i, j + 1, k, KBSE) + S(i, j + 1, k, KBS)
                     + S(i + 1, j + 1, k, KBSW)
                     + S(i, j, k, KBE) + S(i, j, k, KB) + S(i + 1, j, k, KBW)
                     + S(i, j, k, KBNE) + S(i, j, k, KBN) + S(i + 1, j, k, KBNW))
                b = (S(i, j + 1, k - 1, KBNW) + S(i, j + 1, k - 1, KBN)
                     + S(i + 1, j + 1, k - 1, KBNE) + S(i, j, k - 1, KBW)
                     + S(i, j, k - 1, KB) + S(i + 1, j, k - 1, KBE)
                     + S(i, j, k - 1, KBSW) + S(i, j, k - 1, KBS)
                     + S(i + 1, j, k - 1, KBSE))
                p = S(i, j, k - 1, KP)
                c = (a + b + S(i, j, k - 1, KPW) + S(i + 1, j, k - 1, KPW)
                     + S(i, j + 1, k - 1, KPNW) + S(i, j + 1, k - 1, KPS)
                     + S(i + 1, j + 1, k - 1, KPSW) + S(i, j, k - 1, KPSW)
                     + S(i, j, k - 1, KPS) + S(i + 1, j, k - 1, KPNW))
                ep = min(abs(a / p), abs(b / p))
                c = guard(p, a + b, c, ep)
                setC(LXZA, ic, jc, kc, a / c)
                setC(LXZB, ic, jc, kc, b / c)

    # xy-face centers (:234-283)
    k = 0
    for kc in range(2, kkc1 + 1):
        k += 2
        j = 2
        for jc in range(3, jjcf1 + 1):
            j += 2
            i = 2
            for ic in range(3, iicf1 + 1):
                i += 2
                dnw = (S(i - 1, j, k, KPNW) + S(i - 1, j, k, KBNW)
                       + S(i - 1, j, k + 1, KBSE))
                dn = (S(i - 1, j, k, KPS) + S(i - 1, j, k, KBN)
                      + S(i - 1, j, k + 1, KBS))
                dne = (S(i, j, k, KPSW) + S(i, j, k, KBNE)
                       + S(i, j, k + 1, KBSW))
                dw = (S(i - 1, j - 1, k, KPW) + S(i - 1, j - 1, k, KBW)
                      + S(i - 1, j - 1, k + 1, KBE))
                de = (S(i, j - 1, k, KPW) + S(i, j - 1, k, KBE)
                      + S(i, j - 1, k + 1, KBW))
                dsw = (S(i - 1, j - 1, k, KPSW) + S(i - 1, j - 1, k, KBSW)
                       + S(i - 1, j - 1, k + 1, KBNE))
                ds = (S(i - 1, j - 1, k, KPS) + S(i - 1, j - 1, k, KBS)
                      + S(i - 1, j - 1, k + 1, KBN))
                dse = (S(i, j - 1, k, KPNW) + S(i, j - 1, k, KBSE)
                       + S(i, j - 1, k + 1, KBNW))
                p = S(i - 1, j - 1, k, KP)
                ep = min(abs((dsw + dw + dnw) / p), abs((dnw + dn + dne) / p),
                         abs((dne + de + dse) / p), abs((dse + ds + dsw) / p))
                dp = dw + dnw + dn + dne + de + dse + ds + dsw
                summ = p - S(i - 1, j - 1, k, KB) - S(i - 1, j - 1, k + 1, KB)
                dd = summ - (1.0 + ep) * dp
                dp = dp + (summ - dp) * max(dd, 0.0) / (abs(dd) + eps)
                dp = 1.0 / dp
                setC(LXYNW, ic, jc, kc,
                     dp * (dnw + C(LXYA, ic - 1, jc, kc) * dw
                           + C(LXYL, ic, jc, kc) * dn))
                setC(LXYNE, ic, jc, kc,
                     dp * (dne + C(LXYR, ic, jc, kc) * dn
                           + C(LXYA, ic, jc, kc) * de))
                setC(LXYSE, ic, jc, kc,
                     dp * (dse + C(LXYB, ic, jc, kc) * de
                           + C(LXYR, ic, jc - 1, kc) * ds))
                setC(LXYSW, ic, jc, kc,
                     dp * (dsw + C(LXYL, ic, jc - 1, kc) * ds
                           + C(LXYB, ic - 1, jc, kc) * dw))

    # xz-face centers (:285-332)
    k = 2
    for kc in range(3, kkcf1 + 1):
        k += 2
        j = 0
        for jc in range(2, jjc1 + 1):
            j += 2
            i = 2
            for ic in range(3, iicf1 + 1):
                i += 2
                dnw = (S(i - 1, j + 1, k, KBSE) + S(i - 1, j, k, KBE)
                       + S(i - 1, j, k, KBNE))
                dn = (S(i - 1, j + 1, k, KBS) + S(i - 1, j, k, KB)
                      + S(i - 1, j, k, KBN))
                dne = (S(i, j + 1, k, KBSW) + S(i, j, k, KBW)
                       + S(i, j, k, KBNW))
                dw = (S(i - 1, j + 1, k - 1, KPNW) + S(i - 1, j, k - 1, KPW)
                      + S(i - 1, j, k - 1, KPSW))
                de = (S(i, j + 1, k - 1, KPSW) + S(i, j, k - 1, KPW)
                      + S(i, j, k - 1, KPNW))
                dsw = (S(i - 1, j + 1, k - 1, KBNW) + S(i - 1, j, k - 1, KBW)
                       + S(i - 1, j, k - 1, KBSW))
                ds = (S(i - 1, j + 1, k - 1, KBN) + S(i - 1, j, k - 1, KB)
                      + S(i - 1, j, k - 1, KBS))
                dse = (S(i, j + 1, k - 1, KBNE) + S(i, j, k - 1, KBE)
                       + S(i, j, k - 1, KBSE))
                p = S(i - 1, j, k - 1, KP)
                ep = min(abs((dsw + dw + dnw) / p), abs((dnw + dn + dne) / p),
                         abs((dne + de + dse) / p), abs((dse + ds + dsw) / p))
                dp = dw + dnw + dn + dne + de + dse + ds + dsw
                summ = (p - S(i - 1, j + 1, k - 1, KPS)
                        - S(i - 1, j, k - 1, KPS))
                dd = summ - (1.0 + ep) * dp
                dp = dp + (summ - dp) * max(dd, 0.0) / (abs(dd) + eps)
                dp = 1.0 / dp
                setC(LXZNW, ic, jc, kc,
                     dp * (dnw + C(LXZA, ic - 1, jc, kc) * dw
                           + C(LXYL, ic, jc, kc) * dn))
                setC(LXZNE, ic, jc, kc,
                     dp * (dne + C(LXYR, ic, jc, kc) * dn
                           + C(LXZA, ic, jc, kc) * de))
                setC(LXZSE, ic, jc, kc,
                     dp * (dse + C(LXZB, ic, jc, kc) * de
                           + C(LXYR, ic, jc, kc - 1) * ds))
                setC(LXZSW, ic, jc, kc,
                     dp * (dsw + C(LXYL, ic, jc, kc - 1) * ds
                           + C(LXZB, ic - 1, jc, kc) * dw))

    # yz-face centers (:334-382)
    k = 2
    for kc in range(3, kkcf1 + 1):
        k += 2
        j = 2
        for jc in range(3, jjcf1 + 1):
            j += 2
            i = 0
            for ic in range(2, iic1 + 1):
                i += 2
                dnw = (S(i, j, k, KBSE) + S(i, j, k, KBS)
                       + S(i + 1, j, k, KBSW))
                dn = (S(i, j - 1, k, KBE) + S(i, j - 1, k, KB)
                      + S(i + 1, j - 1, k, KBW))
                dne = (S(i, j - 1, k, KBNE) + S(i, j - 1, k, KBN)
                       + S(i + 1, j - 1, k, KBNW))
                dw = (S(i, j, k - 1, KPNW) + S(i, j, k - 1, KPS)
                      + S(i + 1, j, k - 1, KPSW))
                de = (S(i, j - 1, k - 1, KPSW) + S(i, j - 1, k - 1, KPS)
                      + S(i + 1, j - 1, k - 1, KPNW))
                dsw = (S(i, j, k - 1, KBNW) + S(i, j, k - 1, KBN)
                       + S(i + 1, j, k - 1, KBNE))
                ds = (S(i, j - 1, k - 1, KBW) + S(i, j - 1, k - 1, KB)
                      + S(i + 1, j - 1, k - 1, KBE))
                dse = (S(i, j - 1, k - 1, KBSW) + S(i, j - 1, k - 1, KBS)
                       + S(i + 1, j - 1, k - 1, KBSE))
                p = S(i, j - 1, k - 1, KP)
                ep = min(abs((dsw + dw + dnw) / p), abs((dnw + dn + dne) / p),
                         abs((dne + de + dse) / p), abs((dse + ds + dsw) / p))
                dp = dw + dnw + dn + dne + de + dse + ds + dsw
                summ = (p - S(i, j - 1, k - 1, KPW)
                        - S(i + 1, j - 1, k - 1, KPW))
                dd = summ - (1.0 + ep) * dp
                dp = dp + (summ - dp) * max(dd, 0.0) / (abs(dd) + eps)
                dp = 1.0 / dp
                setC(LYZNW, ic, jc, kc,
                     dp * (dnw + C(LXZA, ic, jc, kc) * dw
                           + C(LXYA, ic, jc, kc) * dn))
                setC(LYZNE, ic, jc, kc,
                     dp * (dne + C(LXYB, ic, jc, kc) * dn
                           + C(LXZA, ic, jc - 1, kc) * de))
                setC(LYZSE, ic, jc, kc,
                     dp * (dse + C(LXZB, ic, jc - 1, kc) * de
                           + C(LXYB, ic, jc, kc - 1) * ds))
                setC(LYZSW, ic, jc, kc,
                     dp * (dsw + C(LXYA, ic, jc, kc - 1) * ds
                           + C(LXZB, ic, jc, kc) * dw))

    # cell centers (:384-536; guard normalization per module docstring)
    k = 2
    for kc in range(3, kkcf1 + 1):
        k += 2
        j = 2
        for jc in range(3, jjcf1 + 1):
            j += 2
            i = 2
            for ic in range(3, iicf1 + 1):
                i += 2
                p = S(i - 1, j - 1, k - 1, KP)
                total = (
                    S(i - 1, j - 1, k - 1, KPW) + S(i - 1, j, k - 1, KPNW)
                    + S(i - 1, j, k - 1, KPS) + S(i, j, k - 1, KPSW)
                    + S(i, j - 1, k - 1, KPW) + S(i, j - 1, k - 1, KPNW)
                    + S(i - 1, j - 1, k - 1, KPS) + S(i - 1, j - 1, k - 1, KPSW)
                    + S(i - 1, j - 1, k - 1, KB) + S(i - 1, j - 1, k - 1, KBW)
                    + S(i - 1, j, k - 1, KBNW) + S(i - 1, j, k - 1, KBN)
                    + S(i, j, k - 1, KBNE) + S(i, j - 1, k - 1, KBE)
                    + S(i, j - 1, k - 1, KBSE) + S(i - 1, j - 1, k - 1, KBS)
                    + S(i - 1, j - 1, k - 1, KBSW) + S(i - 1, j - 1, k, KB)
                    + S(i - 1, j - 1, k, KBE) + S(i - 1, j, k, KBSE)
                    + S(i - 1, j, k, KBS) + S(i, j, k, KBSW)
                    + S(i, j - 1, k, KBW) + S(i, j - 1, k, KBNW)
                    + S(i - 1, j - 1, k, KBN) + S(i - 1, j - 1, k, KBNE)
                )
                west = (S(i - 1, j - 1, k - 1, KPW) + S(i - 1, j, k - 1, KPNW)
                        + S(i - 1, j, k, KBSE) + S(i - 1, j - 1, k, KBE)
                        + S(i - 1, j - 1, k, KBNE) + S(i - 1, j - 1, k - 1, KPSW)
                        + S(i - 1, j - 1, k - 1, KBSW)
                        + S(i - 1, j - 1, k - 1, KBW)
                        + S(i - 1, j, k - 1, KBNW))
                east = (S(i, j - 1, k - 1, KPW) + S(i, j, k - 1, KPSW)
                        + S(i, j, k, KBSW) + S(i, j - 1, k, KBW)
                        + S(i, j - 1, k, KBNW) + S(i, j - 1, k - 1, KPNW)
                        + S(i, j - 1, k - 1, KBSE) + S(i, j - 1, k - 1, KBE)
                        + S(i, j, k - 1, KBNE))
                north = (S(i - 1, j, k - 1, KPS) + S(i - 1, j, k - 1, KPNW)
                         + S(i - 1, j, k, KBSE) + S(i - 1, j, k, KBS)
                         + S(i, j, k, KBSW) + S(i, j, k - 1, KPSW)
                         + S(i, j, k - 1, KBNE) + S(i - 1, j, k - 1, KBN)
                         + S(i - 1, j, k - 1, KBNW))
                south = (S(i - 1, j - 1, k - 1, KPS)
                         + S(i - 1, j - 1, k - 1, KPSW)
                         + S(i - 1, j - 1, k, KBNE) + S(i - 1, j - 1, k, KBN)
                         + S(i, j - 1, k, KBNW) + S(i, j - 1, k - 1, KPNW)
                         + S(i, j - 1, k - 1, KBSE) + S(i - 1, j - 1, k - 1, KBS)
                         + S(i - 1, j - 1, k - 1, KBSW))
                bottom = (S(i - 1, j - 1, k - 1, KB)
                          + S(i - 1, j - 1, k - 1, KBW)
                          + S(i - 1, j, k - 1, KBNW) + S(i - 1, j, k - 1, KBN)
                          + S(i, j, k - 1, KBNE) + S(i, j - 1, k - 1, KBE)
                          + S(i, j - 1, k - 1, KBSE)
                          + S(i - 1, j - 1, k - 1, KBS)
                          + S(i - 1, j - 1, k - 1, KBSW))
                top = (S(i - 1, j - 1, k, KB) + S(i - 1, j - 1, k, KBE)
                       + S(i - 1, j, k, KBSE) + S(i - 1, j, k, KBS)
                       + S(i, j, k, KBSW) + S(i, j - 1, k, KBW)
                       + S(i, j - 1, k, KBNW) + S(i - 1, j - 1, k, KBN)
                       + S(i - 1, j - 1, k, KBNE))
                ep = min(abs(west / p), abs(east / p), abs(north / p),
                         abs(south / p), abs(bottom / p), abs(top / p))
                dd = p - (1.0 + ep) * total
                dp = total + (p - total) * max(dd, 0.0) / (abs(dd) + eps)
                s = 1.0 / dp
                setC(LTNW, ic, jc, kc,
                     s * (S(i - 1, j, k, KBSE)
                          + C(LYZNW, ic - 1, jc, kc) * S(i - 1, j - 1, k - 1, KPW)
                          + C(LXZA, ic - 1, jc, kc) * S(i - 1, j, k - 1, KPNW)
                          + C(LXZNW, ic, jc, kc) * S(i - 1, j, k - 1, KPS)
                          + C(LXYA, ic - 1, jc, kc) * S(i - 1, j - 1, k, KBE)
                          + C(LXYL, ic, jc, kc) * S(i - 1, j, k, KBS)
                          + C(LXYNW, ic, jc, kc) * S(i - 1, j - 1, k, KB)))
                setC(LTNE, ic, jc, kc,
                     s * (S(i, j, k, KBSW)
                          + C(LXZNE, ic, jc, kc) * S(i - 1, j, k - 1, KPS)
                          + C(LXZA, ic, jc, kc) * S(i, j, k - 1, KPSW)
                          + C(LYZNW, ic, jc, kc) * S(i, j - 1, k - 1, KPW)
                          + C(LXYR, ic, jc, kc) * S(i - 1, j, k, KBS)
                          + C(LXYA, ic, jc, kc) * S(i, j - 1, k, KBW)
                          + C(LXYNE, ic, jc, kc) * S(i - 1, j - 1, k, KB)))
                setC(LBNW, ic, jc, kc,
                     s * (S(i - 1, j, k - 1, KBNW)
                          + C(LXYA, ic - 1, jc, kc - 1) * S(i - 1, j - 1, k - 1, KBW)
                          + C(LXYL, ic, jc, kc - 1) * S(i - 1, j, k - 1, KBN)
                          + C(LXYNW, ic, jc, kc - 1) * S(i - 1, j - 1, k - 1, KB)
                          + C(LYZSW, ic - 1, jc, kc) * S(i - 1, j - 1, k - 1, KPW)
                          + C(LXZB, ic - 1, jc, kc) * S(i - 1, j, k - 1, KPNW)
                          + C(LXZSW, ic, jc, kc) * S(i - 1, j, k - 1, KPS)))
                setC(LBNE, ic, jc, kc,
                     s * (S(i, j, k - 1, KBNE)
                          + C(LXYNE, ic, jc, kc - 1) * S(i - 1, j - 1, k - 1, KB)
                          + C(LXYR, ic, jc, kc - 1) * S(i - 1, j, k - 1, KBN)
                          + C(LXYA, ic, jc, kc - 1) * S(i, j - 1, k - 1, KBE)
                          + C(LXZSE, ic, jc, kc) * S(i - 1, j, k - 1, KPS)
                          + C(LXZB, ic, jc, kc) * S(i, j, k - 1, KPSW)
                          + C(LYZSW, ic, jc, kc) * S(i, j - 1, k - 1, KPW)))
                setC(LBSW, ic, jc, kc,
                     s * (S(i - 1, j - 1, k - 1, KBSW)
                          + C(LXYB, ic - 1, jc, kc - 1) * S(i - 1, j - 1, k - 1, KBW)
                          + C(LXYSW, ic, jc, kc - 1) * S(i - 1, j - 1, k - 1, KB)
                          + C(LXYL, ic, jc - 1, kc - 1) * S(i - 1, j - 1, k - 1, KBS)
                          + C(LYZSE, ic - 1, jc, kc) * S(i - 1, j - 1, k - 1, KPW)
                          + C(LXZSW, ic, jc - 1, kc) * S(i - 1, j - 1, k - 1, KPS)
                          + C(LXZB, ic - 1, jc - 1, kc) * S(i - 1, j - 1, k - 1, KPSW)))
                setC(LTSW, ic, jc, kc,
                     s * (S(i - 1, j - 1, k, KBNE)
                          + C(LXYB, ic - 1, jc, kc) * S(i - 1, j - 1, k, KBE)
                          + C(LXYSW, ic, jc, kc) * S(i - 1, j - 1, k, KB)
                          + C(LXYL, ic, jc - 1, kc) * S(i - 1, j - 1, k, KBN)
                          + C(LYZNE, ic - 1, jc, kc) * S(i - 1, j - 1, k - 1, KPW)
                          + C(LXZNW, ic, jc - 1, kc) * S(i - 1, j - 1, k - 1, KPS)
                          + C(LXZA, ic - 1, jc - 1, kc) * S(i - 1, j - 1, k - 1, KPSW)))
                setC(LTSE, ic, jc, kc,
                     s * (S(i, j - 1, k, KBNW)
                          + C(LXYR, ic, jc - 1, kc) * S(i - 1, j - 1, k, KBN)
                          + C(LXYSE, ic, jc, kc) * S(i - 1, j - 1, k, KB)
                          + C(LXYB, ic, jc, kc) * S(i, j - 1, k, KBW)
                          + C(LXZNE, ic, jc - 1, kc) * S(i - 1, j - 1, k - 1, KPS)
                          + C(LYZNE, ic, jc, kc) * S(i, j - 1, k - 1, KPW)
                          + C(LXZA, ic, jc - 1, kc) * S(i, j - 1, k - 1, KPNW)))
                setC(LBSE, ic, jc, kc,
                     s * (S(i, j - 1, k - 1, KBSE)
                          + C(LXYR, ic, jc - 1, kc - 1) * S(i - 1, j - 1, k - 1, KBS)
                          + C(LXYSE, ic, jc, kc - 1) * S(i - 1, j - 1, k - 1, KB)
                          + C(LXYB, ic, jc, kc - 1) * S(i, j - 1, k - 1, KBE)
                          + C(LXZSE, ic, jc - 1, kc) * S(i - 1, j - 1, k - 1, KPS)
                          + C(LYZSE, ic, jc, kc) * S(i, j - 1, k - 1, KPW)
                          + C(LXZB, ic, jc - 1, kc) * S(i, j - 1, k - 1, KPNW)))
    return ci


# -- restriction (BMG3_SymStd_restrict.f90:112-145) ---------------------------

def restrict(ci, q, nxc, nyc, nzc):
    """ci ghosted (26, IIC, JJC, KKC); q ghosted fine.  Returns ghosted
    coarse."""
    qc = np.zeros((nxc, nyc, nzc))

    def C(d, i, j, k):
        return ci[d, i - 1, j - 1, k - 1]

    def Q(i, j, k):
        return q[i - 1, j - 1, k - 1]

    k = 0
    for kc in range(2, nzc - 1 + 1):
        k += 2
        j = 0
        for jc in range(2, nyc - 1 + 1):
            j += 2
            i = 0
            for ic in range(2, nxc - 1 + 1):
                i += 2
                qc[ic - 1, jc - 1, kc - 1] = (
                    C(LXYNE, ic, jc, kc) * Q(i - 1, j - 1, k)
                    + C(LXYA, ic, jc, kc) * Q(i, j - 1, k)
                    + C(LXYNW, ic + 1, jc, kc) * Q(i + 1, j - 1, k)
                    + C(LXYR, ic, jc, kc) * Q(i - 1, j, k)
                    + Q(i, j, k)
                    + C(LXYL, ic + 1, jc, kc) * Q(i + 1, j, k)
                    + C(LXYSE, ic, jc + 1, kc) * Q(i - 1, j + 1, k)
                    + C(LXYB, ic, jc + 1, kc) * Q(i, j + 1, k)
                    + C(LXYSW, ic + 1, jc + 1, kc) * Q(i + 1, j + 1, k)
                    + C(LTNE, ic, jc, kc) * Q(i - 1, j - 1, k - 1)
                    + C(LYZNW, ic, jc, kc) * Q(i, j - 1, k - 1)
                    + C(LTNW, ic + 1, jc, kc) * Q(i + 1, j - 1, k - 1)
                    + C(LXZNE, ic, jc, kc) * Q(i - 1, j, k - 1)
                    + C(LXZA, ic, jc, kc) * Q(i, j, k - 1)
                    + C(LXZNW, ic + 1, jc, kc) * Q(i + 1, j, k - 1)
                    + C(LTSE, ic, jc + 1, kc) * Q(i - 1, j + 1, k - 1)
                    + C(LYZNE, ic, jc + 1, kc) * Q(i, j + 1, k - 1)
                    + C(LTSW, ic + 1, jc + 1, kc) * Q(i + 1, j + 1, k - 1)
                    + C(LBNE, ic, jc, kc + 1) * Q(i - 1, j - 1, k + 1)
                    + C(LYZSW, ic, jc, kc + 1) * Q(i, j - 1, k + 1)
                    + C(LBNW, ic + 1, jc, kc + 1) * Q(i + 1, j - 1, k + 1)
                    + C(LXZSE, ic, jc, kc + 1) * Q(i - 1, j, k + 1)
                    + C(LXZB, ic, jc, kc + 1) * Q(i, j, k + 1)
                    + C(LXZSW, ic + 1, jc, kc + 1) * Q(i + 1, j, k + 1)
                    + C(LBSE, ic, jc + 1, kc + 1) * Q(i - 1, j + 1, k + 1)
                    + C(LYZSE, ic, jc + 1, kc + 1) * Q(i, j + 1, k + 1)
                    + C(LBSW, ic + 1, jc + 1, kc + 1) * Q(i + 1, j + 1, k + 1)
                )
    return qc


# -- interpolate + add (BMG3_SymStd_interp_add.f90:88-242) --------------------

def interp_add(ci, so_f, q, qc, res, iif, jjf, kkf, iic, jjc, kkc):
    """All arrays ghosted.  Returns updated fine q.

    Implemented via the interpolation footprint (equivalent to the Fortran's
    unrolled loops; adds res/diag at every fine-only interior point)."""
    q = q.copy()
    res = res.copy()
    for k in range(2, kkf - 1 + 1):
        for j in range(2, jjf - 1 + 1):
            for i in range(2, iif - 1 + 1):
                res[i - 1, j - 1, k - 1] /= so_f[KP, i - 1, j - 1, k - 1]

    # footprint: fine offset from coarse -> (plane, ci index shift)
    table = {
        (-1, 0, 0): (LXYR, (0, 0, 0)), (1, 0, 0): (LXYL, (1, 0, 0)),
        (0, -1, 0): (LXYA, (0, 0, 0)), (0, 1, 0): (LXYB, (0, 1, 0)),
        (0, 0, -1): (LXZA, (0, 0, 0)), (0, 0, 1): (LXZB, (0, 0, 1)),
        (-1, -1, 0): (LXYNE, (0, 0, 0)), (1, -1, 0): (LXYNW, (1, 0, 0)),
        (-1, 1, 0): (LXYSE, (0, 1, 0)), (1, 1, 0): (LXYSW, (1, 1, 0)),
        (-1, 0, -1): (LXZNE, (0, 0, 0)), (1, 0, -1): (LXZNW, (1, 0, 0)),
        (-1, 0, 1): (LXZSE, (0, 0, 1)), (1, 0, 1): (LXZSW, (1, 0, 1)),
        (0, -1, -1): (LYZNW, (0, 0, 0)), (0, 1, -1): (LYZNE, (0, 1, 0)),
        (0, -1, 1): (LYZSW, (0, 0, 1)), (0, 1, 1): (LYZSE, (0, 1, 1)),
        (-1, -1, -1): (LTNE, (0, 0, 0)), (1, -1, -1): (LTNW, (1, 0, 0)),
        (-1, 1, -1): (LTSE, (0, 1, 0)), (1, 1, -1): (LTSW, (1, 1, 0)),
        (-1, -1, 1): (LBNE, (0, 0, 1)), (1, -1, 1): (LBNW, (1, 0, 1)),
        (-1, 1, 1): (LBSE, (0, 1, 1)), (1, 1, 1): (LBSW, (1, 1, 1)),
    }
    nxf, nyf, nzf = iif - 2, jjf - 2, kkf - 2  # interior counts
    add = np.zeros_like(q)
    # P qc: loop over coarse interior points and scatter
    for kc in range(2, kkc - 1 + 1):
        for jc in range(2, jjc - 1 + 1):
            for ic in range(2, iic - 1 + 1):
                i, j, k = 2 * (ic - 1), 2 * (jc - 1), 2 * (kc - 1)
                v = qc[ic - 1, jc - 1, kc - 1]
                add[i - 1, j - 1, k - 1] += v
                for (du, dv, dw), (plane, sh) in table.items():
                    fi, fj, fk = i + du, j + dv, k + dw
                    if not (2 <= fi <= iif - 1 and 2 <= fj <= jjf - 1
                            and 2 <= fk <= kkf - 1):
                        continue
                    w = ci[plane, ic - 1 + sh[0], jc - 1 + sh[1],
                           kc - 1 + sh[2]]
                    add[fi - 1, fj - 1, fk - 1] += w * v
    q += add
    # residual correction at fine-only interior points
    for k in range(2, kkf - 1 + 1):
        for j in range(2, jjf - 1 + 1):
            for i in range(2, iif - 1 + 1):
                if i % 2 == 0 and j % 2 == 0 and k % 2 == 0:
                    continue
                q[i - 1, j - 1, k - 1] += res[i - 1, j - 1, k - 1]
    return q
