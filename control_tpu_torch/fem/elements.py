"""Reference-element tabulations for structured 2-D meshes.

All cells of a structured mesh are geometrically identical, so basis-function
values/derivatives at quadrature points are computed once (in numpy, float64)
and enter the jitted compute path as constants.

Two cell types share one node layout:

* ``quad``     -- tensor-product Lagrange Q_d on the unit cell [0,1]^2.
* ``tri``      -- each cell split into two P_d triangles along the diagonal
                  from (0,0) to (1,1).  The union of the two triangles' nodes
                  is exactly the (d+1)x(d+1) cell-local node grid, so gather /
                  scatter are identical to the quad case; only the tabulated
                  basis differs (a node's basis is supported on the triangle(s)
                  containing it and tabulates to 0 at quadrature points of the
                  other triangle).

This replaces the reference's Firedrake/TSFC generated element kernels
(used via ``assemble`` at reference control/control.py:310,329) with static
tables driving batched XLA contractions.
"""

import numpy as np
from functools import lru_cache


# ---------------------------------------------------------------------------
# 1-D Lagrange basis on [0, 1] with equispaced nodes
# ---------------------------------------------------------------------------

def lagrange_1d(degree, points):
    """Values and derivatives of the 1-D Lagrange basis at ``points``.

    Returns (N, dN) with shapes (npts, degree+1).
    """
    points = np.asarray(points, dtype=np.float64)
    nodes = np.linspace(0.0, 1.0, degree + 1)
    n = degree + 1
    N = np.ones((len(points), n))
    dN = np.zeros((len(points), n))
    for a in range(n):
        for b in range(n):
            if b == a:
                continue
            N[:, a] *= (points - nodes[b]) / (nodes[a] - nodes[b])
        # derivative via sum over product-rule terms
        for c in range(n):
            if c == a:
                continue
            term = np.ones(len(points)) / (nodes[a] - nodes[c])
            for b in range(n):
                if b in (a, c):
                    continue
                term *= (points - nodes[b]) / (nodes[a] - nodes[b])
            dN[:, a] += term
    return N, dN


def gauss_1d(n):
    """n-point Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


# ---------------------------------------------------------------------------
# triangle P_d basis (barycentric, equispaced nodes)
# ---------------------------------------------------------------------------

def _p_tri_basis(degree, verts, pts):
    """P_degree Lagrange basis on the triangle with vertices ``verts``.

    Nodes are the equispaced lattice points of the triangle in the standard
    ordering induced by their (x, y) coordinates; returns
    (node_coords (nn,2), N (npts,nn), dN (npts,nn,2)).
    Implemented by monomial inversion (degrees <= 2 used here, well
    conditioned).
    """
    verts = np.asarray(verts, dtype=np.float64)
    # lattice nodes in barycentric steps
    nodes = []
    for i in range(degree + 1):
        for j in range(degree + 1 - i):
            l1 = i / degree if degree > 0 else 0.0
            l2 = j / degree if degree > 0 else 0.0
            l0 = 1.0 - l1 - l2
            nodes.append(l0 * verts[0] + l1 * verts[1] + l2 * verts[2])
    nodes = np.asarray(nodes)
    nn = len(nodes)

    # monomial exponents of total degree <= degree
    exps = [(p, q) for p in range(degree + 1) for q in range(degree + 1 - p)]
    assert len(exps) == nn

    V = np.zeros((nn, nn))
    for k, (p, q) in enumerate(exps):
        V[:, k] = nodes[:, 0] ** p * nodes[:, 1] ** q
    C = np.linalg.inv(V)  # coeffs: basis_a = sum_k C[k, a] x^p y^q

    pts = np.asarray(pts, dtype=np.float64)
    npts = len(pts)
    P = np.zeros((npts, nn))
    Px = np.zeros((npts, nn))
    Py = np.zeros((npts, nn))
    for k, (p, q) in enumerate(exps):
        xp = pts[:, 0] ** p
        yq = pts[:, 1] ** q
        P[:, k] = xp * yq
        Px[:, k] = (p * pts[:, 0] ** (p - 1) if p > 0 else 0.0) * yq
        Py[:, k] = xp * (q * pts[:, 1] ** (q - 1) if q > 0 else 0.0)
    N = P @ C
    dN = np.einsum("pkd,ka->pad", np.stack([Px, Py], axis=-1), C)
    return nodes, N, dN


def _tri_quadrature(nq1d):
    """Quadrature on the reference triangle (0,0),(1,0),(1,1) via a Duffy
    (collapsed Gauss) map; exactness ~ total degree 2*nq1d - 2."""
    gx, gw = gauss_1d(nq1d)
    pts = []
    wts = []
    for i in range(nq1d):
        for j in range(nq1d):
            x = gx[i]
            y = gx[j] * gx[i]       # 0 <= y <= x
            pts.append((x, y))
            wts.append(gw[i] * gw[j] * gx[i])
    return np.asarray(pts), np.asarray(wts)


# ---------------------------------------------------------------------------
# cell tabulation
# ---------------------------------------------------------------------------

def cell_node_offsets(degree, ndim=2):
    """Cell-local node positions, shape ((d+1)**ndim, ndim), ordered
    major-to-minor as (z,) y, x:  a = (az*(d+1) + ay)*(d+1) + ax with node
    at (ax/d, ay/d[, az/d])."""
    d = degree
    out = []
    if ndim == 3:
        for az in range(d + 1):
            for ay in range(d + 1):
                for ax in range(d + 1):
                    out.append((ax / d if d else 0.0, ay / d if d else 0.0,
                                az / d if d else 0.0))
        return np.asarray(out, dtype=np.float64)
    for ay in range(d + 1):
        for ax in range(d + 1):
            out.append((ax / d if d else 0.0, ay / d if d else 0.0))
    return np.asarray(out, dtype=np.float64)


@lru_cache(maxsize=None)
def _quad_points_key(cell, nq1d):
    """Quadrature points/weights on the unit cell for the given cell type."""
    if cell == "quad":
        gx, gw = gauss_1d(nq1d)
        pts = np.asarray([(x, y) for y in gx for x in gx])
        wts = np.asarray([wy * wx for wy in gw for wx in gw])
        return pts, wts
    elif cell == "tri":
        # lower triangle (0,0),(1,0),(1,1) and upper (0,0),(1,1),(0,1)
        p_lo, w_lo = _tri_quadrature(nq1d)
        p_up = p_lo[:, ::-1].copy()      # swap x/y: reflect across diagonal
        w_up = w_lo.copy()
        return np.concatenate([p_lo, p_up]), np.concatenate([w_lo, w_up])
    elif cell == "hex":
        gx, gw = gauss_1d(nq1d)
        pts = np.asarray([(x, y, z) for z in gx for y in gx for x in gx])
        wts = np.asarray([wz * wy * wx for wz in gw for wy in gw
                          for wx in gw])
        return pts, wts
    raise ValueError(f"unknown cell type {cell!r}")


def cell_quadrature(cell, nq1d):
    pts, wts = _quad_points_key(cell, nq1d)
    return pts.copy(), wts.copy()


def tabulate_scalar(cell, degree, points):
    """Tabulate the scalar cell basis at given cell-reference ``points``.

    Returns (N (npts, nloc), dN (npts, nloc, 2)) with nloc = (degree+1)**2,
    nodes ordered y-major (see :func:`cell_node_offsets`).

    For ``tri`` cells the basis is the continuous P_degree space on the two
    sub-triangles; points must lie in the closed cell, and points on the
    diagonal are attributed to the lower triangle.
    """
    points = np.asarray(points, dtype=np.float64)
    d = degree
    npts = len(points)

    if cell == "hex":
        # tensor-product Lagrange Q_d on [0,1]^3; nodes z-major (see
        # cell_node_offsets(..., ndim=3)); dN (npts, nloc, 3)
        nloc = (d + 1) ** 3
        Nx, dNx = lagrange_1d(d, points[:, 0])
        Ny, dNy = lagrange_1d(d, points[:, 1])
        Nz, dNz = lagrange_1d(d, points[:, 2])
        N = np.zeros((npts, nloc))
        dN = np.zeros((npts, nloc, 3))
        for az in range(d + 1):
            for ay in range(d + 1):
                for ax in range(d + 1):
                    a = (az * (d + 1) + ay) * (d + 1) + ax
                    N[:, a] = Nx[:, ax] * Ny[:, ay] * Nz[:, az]
                    dN[:, a, 0] = dNx[:, ax] * Ny[:, ay] * Nz[:, az]
                    dN[:, a, 1] = Nx[:, ax] * dNy[:, ay] * Nz[:, az]
                    dN[:, a, 2] = Nx[:, ax] * Ny[:, ay] * dNz[:, az]
        return N, dN

    nloc = (d + 1) ** 2

    if cell == "quad":
        Nx, dNx = lagrange_1d(d, points[:, 0])
        Ny, dNy = lagrange_1d(d, points[:, 1])
        N = np.zeros((npts, nloc))
        dN = np.zeros((npts, nloc, 2))
        for ay in range(d + 1):
            for ax in range(d + 1):
                a = ay * (d + 1) + ax
                N[:, a] = Nx[:, ax] * Ny[:, ay]
                dN[:, a, 0] = dNx[:, ax] * Ny[:, ay]
                dN[:, a, 1] = Nx[:, ax] * dNy[:, ay]
        return N, dN

    if cell == "tri":
        offs = cell_node_offsets(d)
        N = np.zeros((npts, nloc))
        dN = np.zeros((npts, nloc, 2))
        lo_verts = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0)]
        up_verts = [(0.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
        in_lo = points[:, 1] <= points[:, 0] + 1e-12
        for verts, mask in ((lo_verts, in_lo), (up_verts, ~in_lo)):
            if not mask.any():
                continue
            tn, tN, tdN = _p_tri_basis(d, verts, points[mask])
            # map triangle nodes to cell-local node indices
            for k, nd in enumerate(tn):
                dist = np.abs(offs - nd[None, :]).sum(axis=1)
                a = int(np.argmin(dist))
                assert dist[a] < 1e-10, "triangle node not on cell lattice"
                N[mask, a] += tN[:, k]
                dN[mask, a, :] += tdN[:, k, :]
        return N, dN

    raise ValueError(f"unknown cell type {cell!r}")
