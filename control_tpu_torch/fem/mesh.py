"""Structured 2-D meshes.

The TPU rebuild restricts the reference's arbitrary Firedrake meshes to
uniform structured rectangle meshes -- which covers every mesh used by the
reference test-suite (``UnitSquareMesh`` / ``RectangleMesh``, triangles and
quadrilaterals; reference test/test_control.py:28,234,1245).  The structured
layout is what makes matrix-free, batched element kernels and geometric
multigrid possible on an accelerator.

Every mesh carries the torch ``dtype`` and ``device`` of the tensors derived
from it (function data, assembled operators, multigrid hierarchies).
"""

import numpy as np
import torch

from ..config import default_dtype, as_torch_dtype


def _mesh_dtype_device(dtype, device):
    dt = default_dtype() if dtype is None else as_torch_dtype(dtype)
    return dt, torch.device("cpu" if device is None else device)


class StructuredMesh2D:
    """Uniform rectangular grid of ``nx`` x ``ny`` cells on
    [x0, x1] x [y0, y1].

    ``cell`` is ``"quad"`` or ``"tri"`` (each rectangle split along the
    diagonal from its lower-left to upper-right corner).
    """

    ndim = 2

    def __init__(self, nx, ny, x0=0.0, x1=1.0, y0=0.0, y1=1.0,
                 cell="quad", dtype=None, device=None):
        if nx < 1 or ny < 1:
            raise ValueError("mesh must have at least one cell per direction")
        if cell not in ("quad", "tri"):
            raise ValueError(f"unknown cell type {cell!r}")
        self.nx = int(nx)
        self.ny = int(ny)
        self.x0, self.x1 = float(x0), float(x1)
        self.y0, self.y1 = float(y0), float(y1)
        self.cell = cell
        self.dtype, self.device = _mesh_dtype_device(dtype, device)
        self.hx = (self.x1 - self.x0) / self.nx
        self.hy = (self.y1 - self.y0) / self.ny

    # API-parity helper (reference code calls space.mesh().comm)
    @property
    def comm(self):
        return None

    @property
    def n_cells(self):
        return self.nx * self.ny

    def cell_origins(self):
        """(ny*nx, 2) array of lower-left corners, cells ordered y-major."""
        xs = self.x0 + self.hx * np.arange(self.nx)
        ys = self.y0 + self.hy * np.arange(self.ny)
        X, Y = np.meshgrid(xs, ys)          # (ny, nx)
        return np.stack([X.ravel(), Y.ravel()], axis=-1)

    def coarsen(self):
        """The mesh with half the cells per direction (for multigrid)."""
        if self.nx % 2 or self.ny % 2:
            raise ValueError("mesh not coarsenable (odd cell count)")
        return StructuredMesh2D(self.nx // 2, self.ny // 2,
                                self.x0, self.x1, self.y0, self.y1,
                                cell=self.cell, dtype=self.dtype,
                                device=self.device)

    def __repr__(self):
        return (f"StructuredMesh2D({self.nx}x{self.ny}, {self.cell}, "
                f"[{self.x0},{self.x1}]x[{self.y0},{self.y1}])")


class StructuredMesh3D:
    """Uniform hexahedral grid of ``nx`` x ``ny`` x ``nz`` cells on
    [x0,x1] x [y0,y1] x [z0,z1].  A capability extension over the
    reference, which is 2-D only (its tests use UnitSquareMesh /
    RectangleMesh exclusively; reference test/test_control.py:28,234);
    the structured 3-D layout keeps the same strided-slicing DOF maps
    and tensor-product element tabulations as the 2-D case.
    """

    ndim = 3
    cell = "hex"

    def __init__(self, nx, ny, nz, x0=0.0, x1=1.0, y0=0.0, y1=1.0,
                 z0=0.0, z1=1.0, dtype=None, device=None):
        if min(nx, ny, nz) < 1:
            raise ValueError("mesh must have at least one cell per direction")
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)
        self.x0, self.x1 = float(x0), float(x1)
        self.y0, self.y1 = float(y0), float(y1)
        self.z0, self.z1 = float(z0), float(z1)
        self.dtype, self.device = _mesh_dtype_device(dtype, device)
        self.hx = (self.x1 - self.x0) / self.nx
        self.hy = (self.y1 - self.y0) / self.ny
        self.hz = (self.z1 - self.z0) / self.nz

    @property
    def comm(self):
        return None

    @property
    def n_cells(self):
        return self.nx * self.ny * self.nz

    def cell_origins(self):
        """(nz*ny*nx, 3) lower corners, cells ordered z-major then y."""
        xs = self.x0 + self.hx * np.arange(self.nx)
        ys = self.y0 + self.hy * np.arange(self.ny)
        zs = self.z0 + self.hz * np.arange(self.nz)
        Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
        return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)

    def coarsen(self):
        if self.nx % 2 or self.ny % 2 or self.nz % 2:
            raise ValueError("mesh not coarsenable (odd cell count)")
        return StructuredMesh3D(self.nx // 2, self.ny // 2, self.nz // 2,
                                self.x0, self.x1, self.y0, self.y1,
                                self.z0, self.z1, dtype=self.dtype,
                                device=self.device)

    def __repr__(self):
        return (f"StructuredMesh3D({self.nx}x{self.ny}x{self.nz}, "
                f"[{self.x0},{self.x1}]x[{self.y0},{self.y1}]"
                f"x[{self.z0},{self.z1}])")


def UnitSquareMesh(nx, ny=None, quadrilateral=False, dtype=None,
                   device=None):
    """Reference-API factory (reference test/test_control.py:28)."""
    if ny is None:
        ny = nx
    return StructuredMesh2D(nx, ny, 0.0, 1.0, 0.0, 1.0,
                            cell="quad" if quadrilateral else "tri",
                            dtype=dtype, device=device)


def RectangleMesh(nx, ny, Lx, Ly, quadrilateral=False, dtype=None,
                  originX=0.0, originY=0.0, device=None):
    return StructuredMesh2D(nx, ny, originX, Lx, originY, Ly,
                            cell="quad" if quadrilateral else "tri",
                            dtype=dtype, device=device)


def UnitCubeMesh(nx, ny=None, nz=None, hexahedral=True, dtype=None,
                 device=None):
    """3-D analogue of UnitSquareMesh (hexahedral cells only)."""
    if not hexahedral:
        raise ValueError("only hexahedral 3-D cells are supported")
    if ny is None:
        ny = nx
    if nz is None:
        nz = nx
    return StructuredMesh3D(nx, ny, nz, dtype=dtype, device=device)


def BoxMesh(nx, ny, nz, Lx, Ly, Lz, hexahedral=True, dtype=None,
            device=None):
    if not hexahedral:
        raise ValueError("only hexahedral 3-D cells are supported")
    return StructuredMesh3D(nx, ny, nz, 0.0, Lx, 0.0, Ly, 0.0, Lz,
                            dtype=dtype, device=device)
