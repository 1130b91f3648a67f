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
