"""Block KKT system solver: nullspace algebra, T-transforms and the
``MultiBlockSystem`` solver.

The reference's solver layer (reference
preconditioner/preconditioner.py:75-786) on stacked tensors:

* the N x N block operator becomes a handful of *stacked diagonal* batched
  matmuls over a (n_blocks, E, b, a) tensor, one per block diagonal;
* nullspace corrections are vectorized mask operations;
* the Crank-Nicolson T1/T2 transforms and their inverses are closed-form
  (alternating-)cumsums along the time axis.
"""

import numpy as np
import torch

from ..fem.forms import Form
from ..fem.space import (Function, MixedFunction, _SubView, DirichletBC,
                         combine_masks)
from ..fem.assemble import assemble
from ..ops.local_op import MaskedOp, local_matvec
from . import krylov

__all__ = ["Nullspace", "NoneNullspace", "ConstantNullspace",
           "DirichletBCNullspace", "FullNullspace", "MultiBlockSystem",
           "apply_T_1", "apply_T_2", "apply_T_1_inv", "apply_T_2_inv"]


# ---------------------------------------------------------------------------
# T transforms along the leading (time-block) axis
# ---------------------------------------------------------------------------

def apply_T_1(x):
    """y_i = x_i + x_{i+1} (last block unchanged);
    reference control/control.py:26-41."""
    y = x.clone()
    y[:-1] += x[1:]
    return y


def apply_T_2(x):
    """y_i = x_i + x_{i-1} (first block unchanged);
    reference control/control.py:44-59."""
    y = x.clone()
    y[1:] += x[:-1]
    return y


def _alt_sign(n, x):
    s = 1.0 - 2.0 * (torch.arange(n, device=x.device) % 2)
    return s.to(x.dtype).reshape((n,) + (1,) * (x.dim() - 1))


def apply_T_1_inv(x):
    """(I + up-shift)^{-1}: y_i = sum_{k>=i} (-1)^{k-i} x_k, evaluated as an
    alternating reversed cumsum."""
    s = _alt_sign(x.shape[0], x)
    c = torch.flip(torch.cumsum(torch.flip(x * s, (0,)), dim=0), (0,))
    return c * s


def apply_T_2_inv(x):
    """(I + down-shift)^{-1}: y_i = sum_{k<=i} (-1)^{i-k} x_k."""
    s = _alt_sign(x.shape[0], x)
    return torch.cumsum(x * s, dim=0) * s


# ---------------------------------------------------------------------------
# nullspaces (reference preconditioner/preconditioner.py:75-213)
# ---------------------------------------------------------------------------

class Nullspace:
    """Constraint projections applied around the operator and the
    preconditioner inside the Krylov solve.  All methods are pure functions
    on a single block's grid tensor."""

    def apply_stacked(self, method, x, *extra):
        """Apply a (composite) method over a leading block axis.  The
        generic version loops; subclasses whose operations broadcast
        override it."""
        outs = [getattr(self, method)(x[i], *[e[i] for e in extra])
                for i in range(x.shape[0])]
        return torch.stack(outs)

    def transform_right(self, x):
        raise NotImplementedError

    def transform_left(self, y):
        raise NotImplementedError

    def extended_correct(self, x, y):
        """y + correction(x) after the operator (keeps it nonsingular)."""
        raise NotImplementedError

    def pc_extended_correct(self, u, b):
        raise NotImplementedError

    # composite operations mirroring the reference
    def correct_soln(self, x):
        return self.transform_right(x)

    def pre_mult_corrected_lhs(self, x):
        return self.transform_right(x)

    def post_mult_correct_lhs(self, y, x):
        """y is the operator output, x the original input block."""
        return self.extended_correct(x, self.transform_left(y))

    def correct_rhs(self, b):
        return self.transform_left(b)

    def pc_pre_mult_corrected(self, b):
        return self.transform_left(b)

    def pc_post_mult_correct(self, u, b):
        """u is the pc output, b the original rhs."""
        return self.pc_extended_correct(self.transform_right(u), b)


class NoneNullspace(Nullspace):
    def apply_stacked(self, method, x, *extra):
        return getattr(self, method)(x, *extra)

    def transform_right(self, x):
        return x

    def transform_left(self, y):
        return y

    def extended_correct(self, x, y):
        return y

    def pc_extended_correct(self, u, b):
        return u


class ConstantNullspace(Nullspace):
    """Mean-subtraction (algebraic mean over dof coefficients, matching
    PETSc vec.sum()/N; reference preconditioner/preconditioner.py:133-155)."""

    def __init__(self, *, alpha=1.0):
        self._alpha = alpha

    @staticmethod
    def _mean(x):
        return torch.sum(x) / x.numel()

    def apply_stacked(self, method, x, *extra):
        """Batched application with per-block means."""
        def m(v):
            return torch.mean(v, dim=tuple(range(1, v.dim())), keepdim=True)
        if method in ("transform_right", "transform_left", "correct_soln",
                      "correct_rhs", "pre_mult_corrected_lhs",
                      "pc_pre_mult_corrected"):
            return x - m(x)
        if method == "post_mult_correct_lhs":
            return (x - m(x)) + self._alpha * m(extra[0])
        if method == "pc_post_mult_correct":
            return (x - m(x)) + m(extra[0])
        raise ValueError(f"unknown nullspace method {method!r}")

    def transform_right(self, x):
        return x - self._mean(x)

    def transform_left(self, y):
        return y - self._mean(y)

    def extended_correct(self, x, y):
        return y + self._alpha * self._mean(x)

    def pc_extended_correct(self, u, b):
        return u + self._mean(b)


class DirichletBCNullspace(Nullspace):
    """Zero bc rows/cols, re-adding alpha*x on the boundary so the operator
    stays nonsingular (reference preconditioner/preconditioner.py:158-197)."""

    def apply_stacked(self, method, x, *extra):
        # elementwise in the grid; the mask broadcasts over the block axis
        return getattr(self, method)(x, *extra)

    def __init__(self, bcs, *, alpha=1.0):
        if isinstance(bcs, DirichletBC):
            bcs = (bcs,)
        bcs = tuple(bcs)
        for bc in bcs:
            if not bc.is_homogeneous:
                raise ValueError("Homogeneous boundary conditions required")
        self._bcs = bcs
        self._alpha = alpha
        self.mask = combine_masks(bcs[0].space, bcs) if bcs else None

    def transform_right(self, x):
        if self.mask is None:
            return x
        return torch.where(self.mask, 0.0, x)

    transform_left = transform_right

    def extended_correct(self, x, y):
        if self.mask is None:
            return y
        return y + self._alpha * torch.where(self.mask, x, 0.0)

    def pc_extended_correct(self, u, b):
        if self.mask is None:
            return u
        return u + torch.where(self.mask, b, 0.0)


class FullNullspace(Nullspace):
    def apply_stacked(self, method, x, *extra):
        return getattr(self, method)(x, *extra)

    def transform_right(self, x):
        return torch.zeros_like(x)

    transform_left = transform_right

    def extended_correct(self, x, y):
        return x

    def pc_extended_correct(self, u, b):
        return b


def _apply_per_block(nullspaces, method, x, *extra):
    """Apply a nullspace method per leading-axis block, vectorized when all
    blocks share one nullspace instance."""
    if all(isinstance(ns, NoneNullspace) for ns in nullspaces):
        return x
    ns0 = nullspaces[0]
    if all(ns is ns0 for ns in nullspaces):
        return ns0.apply_stacked(method, x, *extra)
    outs = [getattr(ns, method)(x[i], *[e[i] for e in extra])
            for i, ns in enumerate(nullspaces)]
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# solve info
# ---------------------------------------------------------------------------

class SolveInfo:
    """Result record (the reference returns the PETSc KSP object)."""

    def __init__(self, iterations, res_norms, converged, rnorm0, rnorm):
        self.iterations = int(iterations)
        self.res_norms = np.asarray(res_norms)
        self.converged = bool(converged)
        self.rnorm0 = float(rnorm0)
        self.rnorm = float(rnorm)

    def monitor_print(self):
        """Reproduce the reference's KSP monitor output
        (reference preconditioner/preconditioner.py:749-754)."""
        for it in range(self.iterations + 1):
            r = self.res_norms[it]
            if np.isnan(r):
                break
            print(f"KSP: iteration {it:d}, residual norm {r:.16e}")


# ---------------------------------------------------------------------------
# block stacking
# ---------------------------------------------------------------------------

class _DiagGroup:
    """All blocks on one diagonal offset of a block dict, stacked."""

    def __init__(self, offset, row_start, A, trial_space, test_space,
                 n_active):
        self.offset = offset
        self.row_start = row_start
        self.A = A                      # (n_active | 1, E | 1, b, a)
        self.trial_space = trial_space
        self.test_space = test_space
        self.n_active = n_active

    def apply_add(self, y, x):
        cs = self.row_start + self.offset
        xe = self.trial_space.gather(x[cs:cs + self.n_active])
        re = local_matvec(self.A, xe)
        contrib = self.test_space.scatter_add(re)
        y = y.clone()
        y[self.row_start:self.row_start + self.n_active] += contrib
        return y


def _build_groups(blocks, n_rows, n_cols, trial_space, test_space):
    """Group a block dict {(i, j): LocalOp|Form|None} by diagonal offset."""
    ops = {}
    for (i, j), blk in blocks.items():
        if blk is None:
            continue
        if isinstance(blk, Form):
            blk = assemble(blk)
        if isinstance(blk, MaskedOp):
            raise TypeError("blocks must be unmasked operators")
        ops[(i, j)] = blk
    groups = []
    for d in sorted({j - i for (i, j) in ops}):
        r0 = max(0, -d)
        r1 = min(n_rows, n_cols - d)
        row_ops = [ops.get((i, i + d)) for i in range(r0, r1)]
        present = [o for o in row_ops if o is not None]
        if not present:
            continue
        if all(o is present[0] for o in row_ops):
            A = present[0].A[None]              # broadcast over rows
        else:
            ref = present[0]
            E = max(o.A.shape[-3] for o in present)
            mats = []
            for o in row_ops:
                if o is None:
                    mats.append(torch.zeros((E,) + tuple(ref.A.shape[-2:]),
                                            dtype=ref.A.dtype,
                                            device=ref.A.device))
                else:
                    mats.append(o.A.expand((E,) + tuple(o.A.shape[-2:])))
            A = torch.stack(mats)
        groups.append(_DiagGroup(d, r0, A, trial_space, test_space,
                                 r1 - r0))
    return groups


class BlockAction:
    """Pure action of a block dict {(i, j): LocalOp|None} on stacked
    vectors (no nullspaces / transforms)."""

    def __init__(self, blocks, n_rows, n_cols, trial_space, test_space):
        self.groups = _build_groups(blocks, n_rows, n_cols, trial_space,
                                    test_space)
        self.n_rows = n_rows
        self.test_space = test_space

    def apply(self, x):
        y = torch.zeros((self.n_rows,) + self.test_space.grid_shape,
                        dtype=x.dtype, device=x.device)
        for g in self.groups:
            y = g.apply_add(y, x)
        return y


# ---------------------------------------------------------------------------
# MultiBlockSystem
# ---------------------------------------------------------------------------

class MultiBlockSystem:
    """The reference's MultiBlockSystem
    (preconditioner/preconditioner.py:216-786) on stacked tensors.

    Unknowns are ``u_0`` (n_blocks_00 blocks of space_0) and ``u_1``
    (n_blocks_11 blocks of space_1); blocks are dicts keyed (i, j) with
    Form / LocalOp / None values.  The preconditioner callable is
    functional: ``pc_fn(b_0, b_1) -> (u_0, u_1)`` on stacked tensors.
    """

    def __init__(self, space_0, space_1,
                 block_00, block_01, block_10, block_11, *,
                 n_blocks_00=1, n_blocks_11=1,
                 sub_n_blocks_00_0=None, sub_n_blocks_11_0=None,
                 nullspace_0=None, nullspace_1=None,
                 form_compiler_parameters=None, CN=False):
        self.space_0, self.space_1 = space_0, space_1
        self.n0, self.n1 = n_blocks_00, n_blocks_11
        self.sub00 = sub_n_blocks_00_0
        self.sub11 = sub_n_blocks_11_0
        self.CN = CN
        if nullspace_0 is None:
            nullspace_0 = tuple(NoneNullspace() for _ in range(self.n0))
        if nullspace_1 is None:
            nullspace_1 = tuple(NoneNullspace() for _ in range(self.n1))
        self.ns0 = tuple(nullspace_0)
        self.ns1 = tuple(nullspace_1)
        if len(self.ns0) != self.n0 or len(self.ns1) != self.n1:
            raise ValueError("one nullspace per block required")

        self.g00 = _build_groups(block_00, self.n0, self.n0,
                                 space_0, space_0)
        self.g01 = _build_groups(block_01, self.n0, self.n1,
                                 space_1, space_0)
        self.g10 = _build_groups(block_10, self.n1, self.n0,
                                 space_0, space_1)
        self.g11 = _build_groups(block_11, self.n1, self.n1,
                                 space_1, space_1)

    # -- operator ------------------------------------------------------------
    def mult(self, x0, x1):
        """The matrix-free block operator, with nullspace pre/post
        correction and CN T-transforms
        (reference preconditioner/preconditioner.py:375-543)."""
        xc0 = _apply_per_block(self.ns0, "pre_mult_corrected_lhs", x0)
        xc1 = _apply_per_block(self.ns1, "pre_mult_corrected_lhs", x1)
        y0 = torch.zeros_like(x0)
        y1 = torch.zeros_like(x1)
        for g in self.g00:
            y0 = g.apply_add(y0, xc0)
        for g in self.g01:
            y0 = g.apply_add(y0, xc1)
        for g in self.g10:
            y1 = g.apply_add(y1, xc0)
        for g in self.g11:
            y1 = g.apply_add(y1, xc1)
        if self.CN:
            if self.sub00 is None and self.sub11 is None:
                y0 = apply_T_1(y0)
                y1 = apply_T_2(y1)
            else:
                s0, s1 = self.sub00, self.sub11
                y0 = torch.cat([apply_T_1(y0[:s0]), apply_T_2(y0[s0:])])
                y1 = torch.cat([apply_T_2(y1[:s1]), apply_T_1(y1[s1:])])
        y0 = _apply_per_block(self.ns0, "post_mult_correct_lhs", y0, x0)
        y1 = _apply_per_block(self.ns1, "post_mult_correct_lhs", y1, x1)
        return y0, y1

    # -- solve ----------------------------------------------------------------
    @staticmethod
    def _as_stack(v, n, space):
        if isinstance(v, MixedFunction):
            if v.n != n:
                raise ValueError("block count mismatch")
            return v.data
        if isinstance(v, (Function, _SubView)):
            if n != 1:
                raise ValueError("block count mismatch")
            return v.data[None]
        v = torch.as_tensor(v, device=space.mesh.device)
        if tuple(v.shape) == (n,) + space.grid_shape:
            return v
        if n == 1 and tuple(v.shape) == space.grid_shape:
            return v[None]
        raise ValueError(f"bad block vector shape {tuple(v.shape)}")

    def _write_back(self, target, stack, n):
        if isinstance(target, MixedFunction):
            target.data = stack
        elif isinstance(target, (Function, _SubView)):
            target.data = stack[0]
        else:
            return stack
        return target

    # every key consumed by the reference's KSP setup
    # (reference preconditioner/preconditioner.py:732-756); unknown keys
    # raise instead of being silently ignored
    _KNOWN_SOLVER_PARAMETERS = frozenset({
        "linear_solver", "gmres_restart", "fgmres_restart",
        "relative_tolerance", "absolute_tolerance", "maximum_iterations",
        "divergence limit", "divergence_limit", "norm_type", "pc_side",
        "monitor_convergence", "preconditioner"})

    @classmethod
    def _resolve_solver_parameters(cls, sp):
        """Validate the reference's solver_parameters dict and resolve
        (method, flexible) from linear_solver / pc_side / norm_type
        (reference preconditioner/preconditioner.py:732-756)."""
        unknown = set(sp) - cls._KNOWN_SOLVER_PARAMETERS
        if unknown:
            raise ValueError(
                f"unknown solver_parameters keys: {sorted(unknown)}")
        method = sp.get("linear_solver", "fgmres")
        norm_type = sp.get("norm_type", "default")
        pc_side = sp.get("pc_side", "default")
        if norm_type not in ("default", "preconditioned",
                             "unpreconditioned"):
            raise ValueError(f"unknown norm_type {norm_type!r}")
        if pc_side not in ("default", "left", "right"):
            raise ValueError(f"unknown pc_side {pc_side!r}")
        if method == "gmres":
            # PETSc GMRES: left pc + preconditioned norm by default; right
            # pc (or unpreconditioned norm) is the flexible kernel with a
            # fixed preconditioner
            if pc_side == "right" and norm_type == "preconditioned":
                raise ValueError(
                    "gmres with pc_side='right' uses the unpreconditioned "
                    "residual norm")
            flexible = pc_side == "right" or norm_type == "unpreconditioned"
        elif method == "fgmres":
            if pc_side == "left" or norm_type == "preconditioned":
                raise ValueError(
                    "fgmres is right-preconditioned with the "
                    "unpreconditioned residual norm")
            flexible = True
        elif method == "minres":
            if pc_side == "right" or norm_type == "unpreconditioned":
                raise ValueError(
                    "minres is left-preconditioned with the "
                    "preconditioned residual norm")
            flexible = False
        else:
            raise ValueError(f"unknown linear_solver {method!r}")
        return method, flexible

    def solve_fn(self, solver_parameters=None, pc_fn=None):
        """A function (u0, u1, b0, b1) -> (u0, u1, info_dict)."""
        sp = dict(solver_parameters or {})
        method, flexible = self._resolve_solver_parameters(sp)
        if method == "gmres" and flexible:
            method = "fgmres"
        rtol = sp.get("relative_tolerance", 1.0e-6)
        atol = sp.get("absolute_tolerance", 0.0)
        maxiter = sp.get("maximum_iterations", 1000)
        dtol = sp.get("divergence limit",
                      sp.get("divergence_limit", None))
        restart = sp.get("gmres_restart",
                         sp.get("fgmres_restart", 30))

        if pc_fn is None:
            def pc_fn(b0, b1):
                return b0, b1

        def wrapped_pc(b):
            b0, b1 = b
            b0c = _apply_per_block(self.ns0, "pc_pre_mult_corrected", b0)
            b1c = _apply_per_block(self.ns1, "pc_pre_mult_corrected", b1)
            u0, u1 = pc_fn(b0c, b1c)
            u0 = _apply_per_block(self.ns0, "pc_post_mult_correct", u0, b0)
            u1 = _apply_per_block(self.ns1, "pc_post_mult_correct", u1, b1)
            return u0, u1

        def operator(x):
            return self.mult(*x)

        def fn(u0, u1, b0, b1):
            u0 = _apply_per_block(self.ns0, "correct_soln", u0)
            u1 = _apply_per_block(self.ns1, "correct_soln", u1)
            b0 = _apply_per_block(self.ns0, "correct_rhs", b0)
            b1 = _apply_per_block(self.ns1, "correct_rhs", b1)
            x, info = krylov.solve_krylov(
                method, operator, (b0, b1), x0=(u0, u1), M=wrapped_pc,
                restart=restart, rtol=rtol, atol=atol, maxiter=maxiter,
                dtol=dtol)
            u0, u1 = x
            u0 = _apply_per_block(self.ns0, "correct_soln", u0)
            u1 = _apply_per_block(self.ns1, "correct_soln", u1)
            return u0, u1, info

        return fn

    def solve(self, u_0, u_1, b_0, b_1, *, solver_parameters=None,
              pc_fn=None):
        sp = dict(solver_parameters or {})
        fn = self.solve_fn(solver_parameters=sp, pc_fn=pc_fn)
        u0 = self._as_stack(u_0, self.n0, self.space_0)
        u1 = self._as_stack(u_1, self.n1, self.space_1)
        b0 = self._as_stack(b_0, self.n0, self.space_0)
        b1 = self._as_stack(b_1, self.n1, self.space_1)
        u0, u1, info = fn(u0, u1, b0, b1)
        info = finalize_solve_info(info, sp)
        self._write_back(u_0, u0, self.n0)
        self._write_back(u_1, u1, self.n1)
        return info


def finalize_solve_info(info_dict, solver_parameters):
    """Convert an info dict to a SolveInfo, print the KSP monitor and raise
    on non-convergence unless running as an inner preconditioner
    (reference preconditioner/preconditioner.py:749-770)."""
    sp = solver_parameters or {}
    info = SolveInfo(info_dict["iterations"], info_dict["res_norms"],
                     info_dict["converged"], info_dict["rnorm0"],
                     info_dict["rnorm"])
    if sp.get("monitor_convergence", True):
        info.monitor_print()
    if not sp.get("preconditioner", False) and not info.converged:
        raise RuntimeError("Solver failed to converge")
    return info
