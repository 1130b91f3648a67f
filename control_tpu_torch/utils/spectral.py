"""Spectral bounds of Jacobi-scaled mass matrices per element type.

The reference's Chebyshev mass solves take user-supplied eigenvalue bounds
(``lambda_v_bounds``; reference control/control.py:370-385, constants at
test/test_control.py:93,308,1184-1188,4250-4251).  These are the verified
bounds for this package's elements on uniform structured meshes (interior
spectrum; vector spaces share the scalar bounds blockwise).  A copy of the
JAX package's table (the port imports nothing of it).  Degrees without an
entry (Q3, Q4) take bounds computed from the assembled mass matrix of a
small mesh.
"""

LAMBDA_BOUNDS = {
    ("quad", 1): (0.25, 2.25),
    ("quad", 2): (0.25, 1.5625),
    ("tri", 1): (0.5, 2.0),
    ("tri", 2): (0.3923, 2.0599),
    # tensor-product spaces: the Jacobi-scaled mass factorises exactly
    # (diag of a Kronecker product is the Kronecker product of diags), so
    # hex bounds are the cubes of the 1-D bounds behind the quad entries
    ("hex", 1): (0.125, 3.375),
    ("hex", 2): (0.125, 1.953125),
}


def mass_lambda_bounds(space):
    """Default Chebyshev bounds for the diag-scaled mass matrix of a space."""
    return LAMBDA_BOUNDS[(space.mesh.cell, space.degree)]


def jacobi_mass_bounds(space):
    """Chebyshev bounds for a space without a table entry: the spectrum
    of diag(M)^{-1} M from the dense mass matrix of ``space`` (a small
    mesh), widened by 0.98 / 1.02 (``tests/test_degree3.py``'s recipe).
    On uniform structured meshes without boundary conditions the interval
    hardly depends on the mesh: hex Q3 gives (0.125, 3.2193) on 1^3 to 4^3
    cells."""
    import numpy as np
    from ..fem import TrialFunction, TestFunction, inner, dx, assemble
    M = assemble(inner(TrialFunction(space), TestFunction(space))
                 * dx).to_dense().cpu().double().numpy()
    d = np.sqrt(np.diag(M))
    lam = np.linalg.eigvalsh(M / d[:, None] / d[None, :])
    return 0.98 * float(lam[0]), 1.02 * float(lam[-1])
