"""Krylov solvers on tuples of tensors.

Replaces PETSc KSP (reference preconditioner/preconditioner.py:732-759):

* ``gmres``   -- left-preconditioned restarted GMRES (PETSc's default GMRES
                 configuration: preconditioned residual norm).
* ``fgmres``  -- flexible GMRES, right-preconditioned, true residual norm.

The iteration runs as a Python loop: vectors and the Arnoldi basis stay on
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


SOLVERS = {"gmres": gmres, "fgmres": fgmres}


def solve_krylov(name, A, b, x0=None, **kw):
    if name == "minres":
        raise NotImplementedError("minres is not ported yet")
    if name not in SOLVERS:
        raise ValueError(f"unknown linear_solver {name!r}")
    return SOLVERS[name](A, b, x0=x0, **kw)
