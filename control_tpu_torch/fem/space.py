"""Function spaces, functions and Dirichlet boundary conditions.

DOF layout: a degree-``d`` Lagrange space on an ``nx`` x ``ny`` structured
mesh stores its coefficients as a dense grid of shape ``(d*ny+1, d*nx+1)``
(plus a trailing component axis for vector spaces), so gather and scatter
are strided slicing, with no index arrays.

DirichletBC is a boolean node mask + value grid; "applying" a BC is a
``torch.where``.  This is the matrix-free analogue of the reference's
bc.apply / DirichletBCNullspace machinery
(reference preconditioner/preconditioner.py:158-197).
"""

import itertools

import numpy as np
import torch

from .expr import Expr


class FunctionSpace:
    """Scalar (or, via ``dim``, vector) Lagrange space of given degree.

    Works on 2-D (quad/tri) and 3-D (hex) structured meshes; the node grid
    is ordered major-to-minor as ([z,] y, x).  Tensors of the space live on
    ``mesh.device`` in ``mesh.dtype``."""

    def __init__(self, mesh, family="Lagrange", degree=1, dim=None):
        if family not in ("Lagrange", "CG", "P", "Q"):
            raise ValueError(f"unsupported family {family!r}")
        self.mesh = mesh
        self.degree = int(degree)
        self.dim = dim                      # None => scalar
        self.ndim = getattr(mesh, "ndim", 2)
        d = self.degree
        self.nodes_x = d * mesh.nx + 1
        self.nodes_y = d * mesh.ny + 1
        if self.ndim == 3:
            self.nodes_z = d * mesh.nz + 1
            node_grid = (self.nodes_z, self.nodes_y, self.nodes_x)
        else:
            node_grid = (self.nodes_y, self.nodes_x)
        self.node_grid = node_grid
        self.value_shape = () if dim is None else (dim,)
        self.grid_shape = (node_grid if dim is None
                           else node_grid + (dim,))
        self.nloc_scalar = (d + 1) ** self.ndim
        self.nloc = self.nloc_scalar * (1 if dim is None else dim)
        self.n_dofs = int(np.prod(self.grid_shape))

    @property
    def device(self):
        return self.mesh.device

    @property
    def dtype(self):
        return self.mesh.dtype

    # -- identity ------------------------------------------------------------
    def _key(self):
        m = self.mesh
        if self.ndim == 3:
            return (3, m.nx, m.ny, m.nz, m.x0, m.x1, m.y0, m.y1,
                    m.z0, m.z1, self.degree, self.dim)
        return (m.nx, m.ny, m.x0, m.x1, m.y0, m.y1, m.cell,
                self.degree, self.dim)

    def __eq__(self, other):
        return (isinstance(other, FunctionSpace)
                and self._key() == other._key())

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(self._key())

    def mesh_(self):
        return self.mesh

    def __repr__(self):
        kind = "Vector" if self.dim else ""
        return (f"{kind}FunctionSpace({self.mesh!r}, degree={self.degree})")

    # -- geometry ------------------------------------------------------------
    def node_coords(self):
        """numpy coordinate arrays (X, Y[, Z]), each of node-grid shape."""
        m = self.mesh
        xs = np.linspace(m.x0, m.x1, self.nodes_x)
        ys = np.linspace(m.y0, m.y1, self.nodes_y)
        if self.ndim == 3:
            zs = np.linspace(m.z0, m.z1, self.nodes_z)
            Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
            return X, Y, Z
        X, Y = np.meshgrid(xs, ys)
        return X, Y

    # -- gather / scatter ----------------------------------------------------
    def _axis_cells(self):
        m = self.mesh
        return (m.nz, m.ny, m.nx) if self.ndim == 3 else (m.ny, m.nx)

    def _node_slices_nd(self, a):
        """Axis slices for cell-local node offset tuple ``a`` (major-to-
        minor, i.e. ([az,] ay, ax))."""
        d = self.degree
        return tuple(slice(ai, ai + d * (nc - 1) + 1, d)
                     for ai, nc in zip(a, self._axis_cells()))

    def gather(self, x):
        """(*batch, *grid_shape) -> (*batch, E, nloc) cell-local coefficients.

        Cells ordered major-to-minor (E = [nz*]ny*nx); local index
        a = ([az*(d+1) +] ay)*(d+1) + ax for scalars, a*dim + c for vectors.
        """
        d, nd = self.degree, self.ndim
        comp_ax = 0 if self.dim is None else 1
        tail = (slice(None),) if self.dim is not None else ()
        pieces = [x[(...,) + self._node_slices_nd(a) + tail]
                  for a in itertools.product(range(d + 1), repeat=nd)]
        st = torch.stack(pieces, dim=-1 - comp_ax)
        batch = st.shape[:st.dim() - (nd + 1 + comp_ax)]
        return st.reshape(tuple(batch) + (self.mesh.n_cells, self.nloc))

    def scatter_add(self, r):
        """(*batch, E, nloc) -> (*batch, *grid_shape), adding overlaps."""
        d, nd = self.degree, self.ndim
        batch = tuple(r.shape[:-2])
        cells = self._axis_cells()
        if self.dim is None:
            rr = r.reshape(batch + cells + (self.nloc_scalar,))
        else:
            rr = r.reshape(batch + cells + (self.nloc_scalar, self.dim))
        out = torch.zeros(batch + self.grid_shape, dtype=r.dtype,
                          device=r.device)
        for i, a in enumerate(itertools.product(range(d + 1), repeat=nd)):
            sl = self._node_slices_nd(a)
            if self.dim is None:
                out[(...,) + sl] += rr[..., i]
            else:
                out[(...,) + sl + (slice(None),)] += rr[..., i, :]
        return out

    def zeros(self, *batch):
        return torch.zeros(tuple(batch) + self.grid_shape,
                           dtype=self.mesh.dtype, device=self.mesh.device)

    # -- boundary masks --------------------------------------------------
    def boundary_mask(self, sub_domain="on_boundary"):
        """Boolean numpy grid mask (no component axis) for a boundary
        subdomain.

        Subdomain ids follow the Firedrake RectangleMesh/BoxMesh
        convention: 1: x = x0, 2: x = x1, 3: y = y0, 4: y = y1
        (3-D additionally 5: z = z0, 6: z = z1).
        """
        mask = np.zeros(self.node_grid, dtype=bool)
        n_faces = 2 * self.ndim
        if sub_domain == "on_boundary":
            ids = tuple(range(1, n_faces + 1))
        elif isinstance(sub_domain, (list, tuple)):
            ids = tuple(sub_domain)
        else:
            ids = (int(sub_domain),)
        for i in ids:
            if not 1 <= i <= n_faces:
                raise ValueError(f"unknown boundary id {i}")
            axis = self.ndim - 1 - (i - 1) // 2   # x: last axis, y, z...
            side = 0 if (i - 1) % 2 == 0 else -1
            idx = [slice(None)] * self.ndim
            idx[axis] = side
            mask[tuple(idx)] = True
        return mask

    def dual(self):
        return self


def VectorFunctionSpace(mesh, family="Lagrange", degree=1, dim=2):
    return FunctionSpace(mesh, family, degree, dim=dim)


def _as_data(space, value):
    return torch.as_tensor(value, dtype=space.mesh.dtype,
                           device=space.mesh.device)


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------

class Function(Expr):
    """FEM function: coefficient grid + space.  Participates in the form
    language as a coefficient terminal."""

    has_function = True
    _is_dual = False

    def __init__(self, space, name=None, data=None):
        self.space = space
        self.name = name
        self.shape = space.value_shape
        if data is None:
            self.data = space.zeros()
        else:
            self.data = _as_data(space, data)
            if tuple(self.data.shape) != space.grid_shape:
                raise ValueError(
                    f"data shape {tuple(self.data.shape)} != "
                    f"{space.grid_shape}")

    def function_space(self):
        return self.space

    def copy(self, deepcopy=True):
        return type(self)(self.space, name=self.name, data=self.data)

    def assign(self, other):
        if isinstance(other, Function):
            if other.space != self.space:
                raise ValueError("assign: space mismatch")
            self.data = other.data
        elif isinstance(other, Expr):
            self.interpolate(other)
        elif np.isscalar(other):
            self.data = torch.full(self.space.grid_shape, float(other),
                                   dtype=self.space.mesh.dtype,
                                   device=self.space.mesh.device)
        else:
            self.data = _as_data(self.space, other)
        return self

    def interpolate(self, value):
        from .assemble import interpolate as _interp
        self.data = _interp(self.space, value)
        return self

    # convenience arithmetic on raw data
    def axpy(self, alpha, other):
        self.data = self.data + alpha * other.data
        return self

    def scale(self, alpha):
        self.data = self.data * alpha
        return self

    def zero(self):
        self.data = torch.zeros_like(self.data)
        return self

    def norm(self):
        return float(torch.sqrt(torch.vdot(self.data.ravel(),
                                           self.data.ravel())))

    def dat(self):  # API-parity placeholder
        return self.data


class Cofunction(Function):
    """Dual-space vector (an assembled linear form).  Same storage."""

    _is_dual = True
    has_function = True


class MixedFunction:
    """A stack of ``n`` functions on the same space: data (n, *grid_shape).

    The replacement for the reference's
    ``MixedFunctionSpace(n_t * (space,))`` all-at-once vectors
    (reference control/control.py:1500-1501).  ``sub(i)`` returns a live view.
    """

    def __init__(self, space, n, data=None, dual=False, name=None):
        self.space = space
        self.n = int(n)
        self.name = name
        self.dual = dual
        if data is None:
            self.data = space.zeros(n)
        else:
            self.data = _as_data(space, data)
            if tuple(self.data.shape) != (n,) + space.grid_shape:
                raise ValueError("MixedFunction data shape mismatch")

    def sub(self, i):
        return _SubView(self, i)

    def assign(self, other):
        if isinstance(other, MixedFunction):
            self.data = other.data
        else:
            self.data = _as_data(self.space, other)
        return self

    def copy(self, deepcopy=True):
        return MixedFunction(self.space, self.n, data=self.data,
                             dual=self.dual, name=self.name)

    def norm(self):
        return float(torch.sqrt(torch.vdot(self.data.ravel(),
                                           self.data.ravel())))


class _SubView(Expr):
    """Live view of one component of a MixedFunction (read/assign)."""

    has_function = True

    def __init__(self, parent, i):
        self.parent = parent
        self.i = int(i)
        self.space = parent.space
        self.shape = parent.space.value_shape

    @property
    def data(self):
        return self.parent.data[self.i]

    @data.setter
    def data(self, value):
        # out-of-place, like the reference's ``.at[i].set``: views taken
        # earlier from the parent's data keep their values
        new = self.parent.data.clone()
        new[self.i] = value
        self.parent.data = new

    def function_space(self):
        return self.space

    def assign(self, other):
        if isinstance(other, (Function, _SubView)):
            self.data = other.data
        elif isinstance(other, Expr):
            from .assemble import interpolate as _interp
            self.data = _interp(self.space, other)
        elif np.isscalar(other):
            self.data = torch.full(self.space.grid_shape, float(other),
                                   dtype=self.space.mesh.dtype,
                                   device=self.space.mesh.device)
        else:
            self.data = _as_data(self.space, other)
        return self

    def interpolate(self, value):
        from .assemble import interpolate as _interp
        self.data = _interp(self.space, value)
        return self


# ---------------------------------------------------------------------------
# boundary conditions
# ---------------------------------------------------------------------------

class _ZeroArg:
    """Sentinel mirroring ufl.classes.Zero for homogeneity checks."""
    pass


class DirichletBC:
    """Dirichlet condition on a structured-mesh boundary subdomain.

    ``g`` may be a scalar, tuple (vector spaces), Expr, or Function; it is
    interpolated onto the space's node grid once at construction.
    """

    def __init__(self, space, g, sub_domain="on_boundary"):
        self.space = space
        self.sub_domain = sub_domain
        self._mask_np = space.boundary_mask(sub_domain)
        mask = torch.as_tensor(self._mask_np, device=space.mesh.device)
        if space.dim is not None:
            mask = mask[..., None].expand(mask.shape + (space.dim,))
        self.mask = mask

        self.is_homogeneous = (np.isscalar(g) and float(g) == 0.0) or (
            isinstance(g, (tuple, list))
            and all(np.isscalar(c) and float(c) == 0.0 for c in g))
        from .assemble import interpolate as _interp
        if isinstance(g, Function):
            if g.space != space:
                raise ValueError("bc value space mismatch")
            self.g = g.data
        else:
            self.g = _interp(space, g)

    @property
    def function_arg(self):
        """Parity with the reference's zero-detection
        (reference control/control.py:499)."""
        return _ZeroArg() if self.is_homogeneous else self.g

    def homogenized(self):
        return DirichletBC(self.space, 0.0 if self.space.dim is None
                           else tuple(0.0 for _ in range(self.space.dim)),
                           self.sub_domain)

    def apply(self, x):
        """Set masked nodes of ``x`` to the boundary value.
        ``x``: Function/Cofunction/_SubView or raw tensor."""
        if isinstance(x, (Function, _SubView)):
            x.data = torch.where(self.mask, self.g.to(x.data.dtype), x.data)
            return x
        return torch.where(self.mask, self.g.to(x.dtype), x)

    def apply_to_array(self, x):
        return torch.where(self.mask, self.g.to(x.dtype), x)


def homogenize(bcs):
    """Zero-valued copies of the given bc or sequence of bcs
    (parity with firedrake.homogenize)."""
    if isinstance(bcs, DirichletBC):
        return bcs.homogenized()
    return tuple(bc.homogenized() for bc in bcs)


def combine_masks(space, bcs):
    """Union of bc masks as a full-grid boolean tensor (with component axis
    for vector spaces); empty bcs -> all-False."""
    mask = torch.zeros(space.grid_shape, dtype=torch.bool,
                       device=space.mesh.device)
    for bc in bcs:
        mask = torch.logical_or(mask, bc.mask)
    return mask
