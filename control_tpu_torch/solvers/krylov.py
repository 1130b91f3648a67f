"""Krylov solvers on tuples of tensors.

Replaces PETSc KSP (reference preconditioner/preconditioner.py:732-759):

* ``gmres``   -- left-preconditioned restarted GMRES (PETSc's default GMRES
                 configuration: preconditioned residual norm).
* ``fgmres``  -- flexible GMRES, right-preconditioned, true residual norm.
* ``minres``  -- preconditioned MINRES for symmetric systems.
* ``chebyshev`` -- Chebyshev semi-iteration with user spectral bounds
                 (the reference's mass-matrix solver,
                 reference control/control.py:377-385).

The iterations run as Python loops: vectors and the Arnoldi basis stay on
the device of the right-hand side; the small Hessenberg column comes to the
host once per iteration, where the Givens rotations, the convergence test
and the back substitution run in the problem's dtype.  Operators and
preconditioners are callables on tuples of tensors; vectors are flattened
once.
"""

import numpy as np
import torch


def _ravel(tree):
    """Flatten a tensor or tuple of tensors into one vector; return it and
    the inverse."""
    if torch.is_tensor(tree):
        shape = tree.shape
        return tree.reshape(-1), lambda v: v.reshape(shape)
    shapes = [t.shape for t in tree]
    sizes = [t.numel() for t in tree]
    flat = torch.cat([t.reshape(-1) for t in tree])

    def unravel(v):
        return tuple(p.reshape(s) for p, s in
                     zip(torch.split(v, sizes), shapes))

    return flat, unravel


def _flat_op(op, unravel):
    if op is None:
        return lambda x: x
    return lambda x: _ravel(op(unravel(x)))[0]


def _np_dtype(t):
    return {torch.float32: np.float32, torch.float64: np.float64}[t.dtype]


def _gmres_impl(A, b, x0, M, restart, rtol, atol, maxiter, flexible,
                dtol=None):
    b_flat, unravel = _ravel(b)
    n = b_flat.shape[0]
    dtype, dev = b_flat.dtype, b_flat.device
    ndt = _np_dtype(b_flat)
    x = _ravel(x0)[0].clone() if x0 is not None else torch.zeros_like(b_flat)
    Af = _flat_op(A, unravel)
    Mf = _flat_op(M, unravel)

    m = restart
    hist = np.full((maxiter + 1,), np.nan, ndt)

    def residual(x):
        r = b_flat - Af(x)
        return Mf(r) if not flexible else r

    def norm(v):
        return ndt(torch.linalg.vector_norm(v).item())

    r = residual(x)
    rnorm0 = norm(r)
    # PETSc KSPConvergedDefault: rtol is relative to the norm of the
    # (preconditioned) right-hand side, not the initial residual
    bnorm = norm(Mf(b_flat)) if not flexible else norm(b_flat)
    tol = max(ndt(rtol * bnorm), ndt(atol))
    # PETSc divtol: declare divergence once rnorm > dtol * rnorm0
    dlim = np.inf if dtol is None else ndt(dtol) * rnorm0
    hist[0] = rnorm0
    it = 0
    rnorm = rnorm0

    while rnorm > tol and it < maxiter and rnorm <= dlim:
        if it > 0:
            r = residual(x)
        beta = norm(r)
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        Z = torch.zeros((m + 1, n), dtype=dtype, device=dev) \
            if flexible else V
        V[0] = r / (beta if beta > 0 else ndt(1.0))
        H = np.zeros((m + 1, m), ndt)
        cs = np.zeros((m,), ndt)
        sn = np.zeros((m,), ndt)
        g = np.zeros((m + 1,), ndt)
        g[0] = beta
        rn = beta
        j = 0
        while j < m and rn > tol and it < maxiter and rn <= dlim:
            if flexible:
                z = Mf(V[j])
                Z[j] = z
                w = Af(z)
            else:
                w = Mf(Af(V[j]))
            # modified Gram-Schmidt over rows 0..j with a second
            # (reorthogonalization) pass: in float32 a single sweep loses
            # basis orthogonality after ~7 vectors and the solve stalls
            hcol = torch.zeros((j + 1,), dtype=dtype, device=dev)
            for _ in range(2):
                for k in range(j + 1):
                    hkj = torch.dot(V[k], w)
                    w = w - hkj * V[k]
                    hcol[k] += hkj
            hj1_t = torch.linalg.vector_norm(w)
            col_dev = torch.cat([hcol, hj1_t[None]]).cpu().numpy()
            hj1 = col_dev[j + 1]
            V[j + 1] = w / (hj1_t if hj1 > 0 else ndt(1.0))
            col = np.zeros((m + 1,), ndt)
            col[:j + 2] = col_dev
            # apply stored Givens rotations to the new column
            for k in range(j):
                t1 = cs[k] * col[k] + sn[k] * col[k + 1]
                t2 = -sn[k] * col[k] + cs[k] * col[k + 1]
                col[k], col[k + 1] = t1, t2
            h1, h2 = col[j], col[j + 1]
            denom = np.sqrt(h1 * h1 + h2 * h2)
            c = h1 / denom if denom > 0 else ndt(1.0)
            s = h2 / denom if denom > 0 else ndt(0.0)
            col[j] = c * h1 + s * h2
            col[j + 1] = 0.0
            H[:, j] = col
            cs[j], sn[j] = c, s
            gj = g[j]
            g[j], g[j + 1] = c * gj, -s * gj
            rn = abs(g[j + 1])
            it += 1
            hist[it] = rn
            j += 1
        rnorm = rn
        # back substitution on the j x j triangular system
        y = np.zeros((m,), ndt)
        for i in range(j - 1, -1, -1):
            num = g[i] - np.dot(H[i, :], y)
            y[i] = num / H[i, i] if H[i, i] != 0 else ndt(0.0)
        basis = Z if flexible else V
        x = x + torch.as_tensor(y, device=dev) @ basis[:m]

    info = {"iterations": it, "res_norms": hist, "rnorm0": rnorm0,
            "rnorm": rnorm, "converged": bool(rnorm <= max(tol, 0.0))}
    return unravel(x), info


def gmres(A, b, x0=None, *, M=None, restart=30, rtol=1e-6, atol=0.0,
          maxiter=1000, dtol=None):
    """Left-preconditioned restarted GMRES (PETSc-default semantics)."""
    return _gmres_impl(A, b, x0, M, restart, rtol, atol, maxiter,
                       flexible=False, dtol=dtol)


def fgmres(A, b, x0=None, *, M=None, restart=30, rtol=1e-6, atol=0.0,
           maxiter=1000, dtol=None):
    """Flexible (right-preconditioned) GMRES; true residual norm."""
    return _gmres_impl(A, b, x0, M, restart, rtol, atol, maxiter,
                       flexible=True, dtol=dtol)


def minres(A, b, x0=None, *, M=None, rtol=1e-6, atol=0.0, maxiter=1000,
           dtol=None):
    """Preconditioned MINRES (A symmetric, M SPD); the residual norm is
    the M-norm of the preconditioned residual, and rtol is relative to the
    initial one."""
    b_flat, unravel = _ravel(b)
    ndt = _np_dtype(b_flat)
    x = _ravel(x0)[0].clone() if x0 is not None else torch.zeros_like(b_flat)
    Af = _flat_op(A, unravel)
    Mf = _flat_op(M, unravel)

    def dot(u, v):
        return ndt(torch.dot(u, v).item())

    r = b_flat - Af(x)
    z = Mf(r)
    gamma = ndt(np.sqrt(max(dot(r, z), 0.0)))
    rnorm0 = gamma
    tol = max(ndt(rtol * rnorm0), ndt(atol))
    dlim = np.inf if dtol is None else ndt(dtol) * rnorm0
    hist = np.full((maxiter + 1,), np.nan, ndt)
    hist[0] = rnorm0
    scale = gamma if gamma > 0 else ndt(1.0)
    v_old, v, z = torch.zeros_like(b_flat), r / scale, z / scale
    w, w_old = torch.zeros_like(b_flat), torch.zeros_like(b_flat)
    eta = gamma
    c = c_old = ndt(1.0)
    s = s_old = ndt(0.0)
    rnorm, it = rnorm0, 0
    while rnorm > tol and it < maxiter and rnorm <= dlim:
        Az = Af(z)
        delta = dot(Az, z)
        v_new = Az - delta * v - gamma * v_old
        z_new = Mf(v_new)
        gamma_new = ndt(np.sqrt(max(dot(v_new, z_new), 1e-300)))
        a0 = c * delta - c_old * s * gamma
        a1 = ndt(np.sqrt(a0 * a0 + gamma_new * gamma_new))
        a2 = s * delta + c_old * c * gamma
        a3 = s_old * gamma
        c_new, s_new = a0 / a1, gamma_new / a1
        w_new = (z - a3 * w_old - a2 * w) / a1
        x = x + (c_new * eta) * w_new
        eta = -s_new * eta
        rnorm = abs(eta)
        it += 1
        hist[it] = rnorm
        v_old, v, z = v, v_new / gamma_new, z_new / gamma_new
        w_old, w = w, w_new
        gamma = gamma_new
        c_old, c, s_old, s = c, c_new, s, s_new
    info = {"iterations": it, "res_norms": hist, "rnorm0": rnorm0,
            "rnorm": rnorm, "converged": bool(rnorm <= tol)}
    return unravel(x), info


def chebyshev(A, b, bounds, iters, x0=None, M=None):
    """Chebyshev iteration for M^{-1}A with spectrum in ``bounds``
    (the reference's 20-iteration Jacobi-preconditioned mass solve,
    reference control/control.py:377-385).  The fused smoother
    (``ops.stencil.fused_cheb_smooth``) runs the same recurrence on node
    stencils."""
    b_flat, unravel = _ravel(b)
    x = _ravel(x0)[0] if x0 is not None else torch.zeros_like(b_flat)
    Af = _flat_op(A, unravel)
    Mf = _flat_op(M, unravel)

    emin, emax = bounds
    theta = 0.5 * (emax + emin)
    delta = 0.5 * (emax - emin)
    sigma1 = theta / delta

    d = Mf(b_flat - Af(x)) / theta
    x = x + d
    rho = 1.0 / sigma1
    for _ in range(iters - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * Mf(b_flat - Af(x))
        x = x + d
        rho = rho_new
    return unravel(x)


def jacobi_apply(diag, b):
    """b / diag, leaf by leaf on tuples."""
    if torch.is_tensor(b):
        return b / diag
    return type(b)(v / d for d, v in zip(diag, b))


SOLVERS = {"gmres": gmres, "fgmres": fgmres, "minres": minres}


def solve_krylov(name, A, b, x0=None, **kw):
    if name not in SOLVERS:
        raise ValueError(f"unknown linear_solver {name!r}")
    if name == "minres":
        kw.pop("restart", None)
    return SOLVERS[name](A, b, x0=x0, **kw)
