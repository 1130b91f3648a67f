"""Stationary PDE-constrained optimal control, the linear path.

The first-order optimality (KKT) system

    [ M_v    D_zeta^T ] [v   ]   [ v_d ]
    [ D_v   -(1/b) M  ] [zeta] = [ f   ]

is solved matrix-free by a preconditioned Krylov method (GMRES(10) by
default; FGMRES and MINRES through the PETSc-style ``solver_parameters``
keys).  The built-in preconditioner is block-triangular with the
Pearson-Wathen matching-Schur approximation
S ~ (D + b^{-1/2} M) M^{-1} (D^T + b^{-1/2} M) (reference
control/control.py:351-450): a mass solve on the (1,1) block (20-step
Chebyshev-Jacobi, kernel K2; plain Jacobi without bounds; two multigrid
cycles with ``Multigrid=True``) and two multigrid applications of two
cycles each on D_v + b^{-1/2} M and its transpose (every smoothed level
kernel K2); the pc's actions of D_v and M run as node stencils (kernel
K1).  Every scalar 2-D degree the
kernels take runs on the card: Q1-Q4 quadrilaterals and P1/P2 triangles.

Not ported (each raises ``NotImplementedError``): the nonlinear and
incompressible solves, the Gauss-Newton linearisation, the JAX package's
mixed-precision iterative refinement, plots.
"""

import numpy as np
import torch

from ..config import full_precision
from ..fem.expr import TrialFunction, TestFunction, inner
from ..fem.forms import dx
from ..fem.space import Function, DirichletBC, homogenize, combine_masks
from ..fem.assemble import assemble
from ..ops.stencil import StencilOp, node_stencil
from ..solvers.block import (MultiBlockSystem, DirichletBCNullspace,
                             NoneNullspace, finalize_solve_info)
from .common import (BlockSolver, mass_solver, zero_rows, picard_operator,
                     bc_lift_function, strip_refinement, tensor_token)


def _as_bcs_tuple(bcs):
    if bcs is None:
        return ()
    if isinstance(bcs, DirichletBC):
        return (bcs,)
    return tuple(bcs)


class Stationary:
    """See module docstring.  API mirrors the reference constructor
    (control/control.py:101-104); both ``force_f`` (documented name) and
    ``force_function`` are accepted.  Tensors follow the space's mesh
    ``device`` and ``dtype``."""

    def __init__(self, space_v, forward_form, desired_state=None,
                 force_f=None, *, beta=10.0**-3, space_p=None,
                 Gauss_Newton=False, bcs_v=None, force_function=None):
        if force_f is None:
            force_f = force_function
        if desired_state is None:
            def desired_state(test_v):
                v_d = Function(space_v, name="v_d")
                return inner(v_d, test_v) * dx, v_d
        if force_f is None:
            def force_f(test_v):
                f = Function(space_v, name="f")
                return inner(f, test_v) * dx

        self._space_p = None
        self._forward_form = forward_form
        self._desired_state = desired_state
        self._force_function = force_f
        self._beta = beta
        self._bcs_v = _as_bcs_tuple(bcs_v)
        self._Gauss_Newton = Gauss_Newton
        self._set_mass_forms(space_v)

        v = Function(space_v, name="v")
        for bc in self._bcs_v:
            bc.apply(v)
        self._v = v
        self._zeta = Function(space_v, name="zeta")
        if space_p is not None:
            self.set_space_p(space_p)
        self._true_v = None
        self._pc_state_cache = {}

    def _set_mass_forms(self, space_v):
        self._space_v = space_v
        v_test, v_trial = TestFunction(space_v), TrialFunction(space_v)
        self._M_v = inner(v_trial, v_test) * dx
        self._M_zeta = inner(v_trial, v_test) * dx

    # ---------------------------------------------------------------- setters
    def set_space_v(self, space_v, *, v=None, zeta=None, bcs_v_new=False,
                    bcs_v=None):
        """Replace the state space, carrying v and zeta over by
        interpolation unless given (e.g. after a mesh refinement)."""
        if v is None:
            v = Function(space_v, name="v").interpolate(self._v)
        elif v.function_space() != space_v:
            raise ValueError("Unexpected space")
        if zeta is None:
            zeta = Function(space_v, name="zeta").interpolate(self._zeta)
        elif zeta.function_space() != space_v:
            raise ValueError("Unexpected space")
        else:
            for bc in homogenize(self._bcs_v):
                bc.apply(zeta)
        self._set_mass_forms(space_v)
        if bcs_v_new:
            self._bcs_v = _as_bcs_tuple(bcs_v)
        for bc in self._bcs_v:
            bc.apply(v)
        self._v, self._zeta = v, zeta

    def set_space_p(self, space_p, *, p=None, mu=None):
        self._space_p = space_p
        p_test, p_trial = TestFunction(space_p), TrialFunction(space_p)
        self._M_p = inner(p_trial, p_test) * dx
        self._M_mu = inner(p_trial, p_test) * dx
        self._p = p if p is not None else Function(space_p, name="p")
        self._mu = mu if mu is not None else Function(space_p, name="mu")

    def set_forward_form(self, forward_form):
        self._forward_form = forward_form

    def set_desired_state(self, desired_state):
        self._desired_state = desired_state

    def set_force_function(self, force_function):
        self._force_function = force_function

    def set_beta(self, beta):
        self._beta = beta

    def set_bcs_v(self, bcs_v, space_v=None):
        if space_v is None:
            self._bcs_v = _as_bcs_tuple(bcs_v)
        else:
            self.set_space_v(space_v, bcs_v_new=True, bcs_v=bcs_v)

    def set_mass_solver_steps(self, steps):
        """Chebyshev step count of the preconditioner's (1,1)-block mass
        solve (the reference fixes 20, control/control.py:377-385); None
        restores it."""
        self._mass_cheb_steps = None if steps is None else int(steps)

    def set_Gauss_Newton(self, Gauss_Newton=True):
        """Only stores the flag: the Gauss-Newton linearisation itself is
        not ported and raises where it would be used."""
        self._Gauss_Newton = Gauss_Newton

    def set_v(self, v_new):
        if v_new.function_space() != self._space_v:
            raise ValueError("Unexpected space")
        h = Function(self._space_v, data=v_new.data)
        for bc in self._bcs_v:
            bc.apply(h)
        self._v.assign(h)

    def set_zeta(self, zeta_new):
        if zeta_new.function_space() != self._space_v:
            raise ValueError("Unexpected space")
        h = Function(self._space_v, data=zeta_new.data)
        for bc in homogenize(self._bcs_v):
            bc.apply(h)
        self._zeta.assign(h)

    def set_p(self, p_new):
        if self._space_p is None:
            raise ValueError("Undefined space_p: unable to assign value")
        self._p.assign(p_new)

    def set_mu(self, mu_new):
        if self._space_p is None:
            raise ValueError("Undefined space_p: unable to assign value")
        self._mu.assign(mu_new)

    def print_error(self):
        err = Function(self._space_v,
                       data=self._v.data - self._true_v.data)
        e = float(np.sqrt(abs(float(assemble(inner(err, err) * dx)))))
        print(f"Estimated error in the L2-norm: {e:.16e}")

    # ------------------------------------------------------------- operators
    def construct_D_v(self, v_old):
        """(D_v, D_zeta) LocalOps at the linearisation state v_old
        (reference control/control.py:314-324), Picard only."""
        if self._Gauss_Newton:
            raise NotImplementedError(
                "the Gauss-Newton linearisation is not ported yet")
        v_test = TestFunction(self._space_v)
        v_trial = TrialFunction(self._space_v)
        D_v = picard_operator(self._forward_form(v_trial, v_test, v_old))
        return D_v, D_v.T

    # ---------------------------------------------------- rhs construction
    def _setup_bcs(self):
        inhom = any(not bc.is_homogeneous for bc in self._bcs_v)
        bcs_v = homogenize(self._bcs_v) if inhom else self._bcs_v
        return inhom, bcs_v, self._bcs_v

    def construct_f(self, inhom, D_v, v_inhom, mask):
        v_test = TestFunction(self._space_v)
        f = assemble(self._force_function(v_test))
        if inhom:
            f.data = zero_rows(mask, f.data - D_v.apply(v_inhom.data))
        return f

    def construct_v_d(self, M_v, inhom, v_inhom, mask):
        v_test = TestFunction(self._space_v)
        v_d_form, true_v = self._desired_state(v_test)
        self._true_v = true_v
        v_d = assemble(v_d_form)
        if inhom:
            v_d.data = zero_rows(mask, v_d.data - M_v.apply(v_inhom.data))
        return v_d

    # ------------------------------------------------------- preconditioner
    def construct_pc(self, Multigrid, lambda_v_bounds, mask_v, mask_zeta,
                     D_v, D_zeta, M_v, prebuilt=None):
        """Block-triangular matching-Schur preconditioner
        (reference control/control.py:351-450).  The returned closure
        carries a ``.state`` dict of its derived tensors (the mass solve's
        stencil, the two hierarchies, the node stencils ``wD`` and ``wM``
        of D_v and M_v); ``prebuilt=`` takes such a state back (a repeat
        solve, or the JAX package's state carried across by
        ``utils.convert.to_torch``, whose missing stencils are folded
        here).  The pc's actions of D_v and M_v run as node stencils
        (kernel K1 on the card), the same operators as the LocalOps."""
        shift = 1.0 / self._beta ** 0.5

        def pb(k):
            return None if prebuilt is None else prebuilt.get(k)

        space = M_v.trial_space
        wD, wM = pb("wD"), pb("wM")
        if wD is None:
            wD = node_stencil(D_v.A, space)
        if wM is None:
            wM = node_stencil(M_v.A, space)
        D_op, M_op = StencilOp(space, wD), StencilOp(space, wM)

        solver_0 = mass_solver(M_v, mask_v, Multigrid, lambda_v_bounds,
                               state=pb("solver_0"),
                               steps=getattr(self, "_mass_cheb_steps",
                                             None))
        solver_1 = BlockSolver(D_v + shift * M_v, mask_zeta, ("mg", 2),
                               state=pb("solver_1"))
        solver_2 = BlockSolver(D_zeta + shift * M_v, mask_zeta, ("mg", 2),
                               state=pb("solver_2"))

        def pc_linear(b_0, b_1):
            u_0 = solver_0(b_0)
            b = zero_rows(mask_zeta, D_op.apply(u_0) - b_1)
            u_1 = solver_1(b)
            b = zero_rows(mask_zeta, M_op.apply(u_1))
            return u_0, solver_2(b)

        pc_linear.state = {"solver_0": solver_0.state,
                           "solver_1": solver_1.state,
                           "solver_2": solver_2.state, "wD": wD, "wM": wM}
        return pc_linear

    def _pc_key(self, Multigrid, lambda_v_bounds, mask, D_v):
        return (self._beta, Multigrid,
                None if lambda_v_bounds is None else tuple(lambda_v_bounds),
                tensor_token(mask), getattr(self, "_mass_cheb_steps", None),
                id(self._space_v), tensor_token(D_v.A))

    # ---------------------------------------------------------- linear solve
    def linear_solve(self, *, P=None, solver_parameters=None,
                     Multigrid=False, lambda_v_bounds=None, v_d=None,
                     f=None, print_error=True, create_output=False,
                     plots=False):
        """The KKT solve at the current state.  ``P``: a user preconditioner
        ``(b_0, b_1) -> (u_0, u_1)`` on (1, *grid) stacks in place of the
        built-in one.  ``v_d`` / ``f``: assembled right-hand sides in place
        of the desired state's and the force's.  The pc state is built
        once per linearisation and reused by repeat solves.  Runs under
        ``config.full_precision()``.  ``create_output=True`` writes
        ``v.npz``/``zeta.npz`` in the working directory.  Returns the
        solve's ``SolveInfo`` (also ``self.last_solve_info``)."""
        if plots:
            raise NotImplementedError("plots are not ported yet")
        solver_parameters = strip_refinement(solver_parameters)
        with full_precision():
            info = self._linear_solve(P, solver_parameters, Multigrid,
                                      lambda_v_bounds, v_d, f, print_error)
        if print_error:
            self.print_error()
        if create_output:
            for name, fn in (("v", self._v), ("zeta", self._zeta)):
                np.savez(f"{name}.npz", data=fn.data.cpu().numpy())
        return info

    def _linear_solve(self, P, solver_parameters, Multigrid,
                      lambda_v_bounds, v_d, f, print_error):
        space_v = self._space_v
        inhom, bcs_v, bcs_v_help = self._setup_bcs()
        mask = combine_masks(space_v, bcs_v) if bcs_v else None
        nullspace = (DirichletBCNullspace(bcs_v) if bcs_v
                     else NoneNullspace())

        v_old = Function(space_v, name="v_old", data=self._v.data)
        D_v, D_zeta = self.construct_D_v(v_old)
        M_v = assemble(self._M_v)
        v_inhom = bc_lift_function(space_v, bcs_v_help) if inhom else None
        if f is None:
            f = self.construct_f(inhom, D_v, v_inhom, mask)
        if v_d is None:
            v_d = self.construct_v_d(M_v, inhom, v_inhom, mask)

        if solver_parameters is None:
            solver_parameters = {"linear_solver": "gmres",
                                 "gmres_restart": 10,
                                 "maximum_iterations": 50,
                                 "relative_tolerance": 1.0e-6,
                                 "absolute_tolerance": 0.0,
                                 "monitor_convergence": print_error}

        if P is None:
            # pc state cached per linearisation (plain dict, a few entries)
            tok = self._pc_key(Multigrid, lambda_v_bounds, mask, D_v)
            pc_state = self._pc_state_cache.get(tok)
            if pc_state is None:
                if len(self._pc_state_cache) > 4:
                    self._pc_state_cache.clear()
                pc_state = self.construct_pc(Multigrid, lambda_v_bounds,
                                             mask, mask, D_v, D_zeta,
                                             M_v).state
                self._pc_state_cache[tok] = pc_state
            pc_1 = self.construct_pc(Multigrid, lambda_v_bounds, mask, mask,
                                     D_v, D_zeta, M_v, prebuilt=pc_state)

            def pc_fn(b0, b1):
                u0, u1 = pc_1(b0[0], b1[0])
                return u0[None], u1[None]
        else:
            pc_fn = P

        M_zeta = assemble(self._M_zeta)
        system = MultiBlockSystem(
            space_v, space_v,
            block_00={(0, 0): M_v}, block_01={(0, 0): D_zeta},
            block_10={(0, 0): D_v},
            block_11={(0, 0): -(1.0 / self._beta) * M_zeta},
            nullspace_0=(nullspace,), nullspace_1=(nullspace,))
        solve = system.solve_fn(solver_parameters=dict(solver_parameters),
                                pc_fn=pc_fn)
        b_0, b_1 = v_d.data[None], f.data[None]
        u0, u1, info_d = solve(torch.zeros_like(b_0), torch.zeros_like(b_1),
                               b_0, b_1)
        info = finalize_solve_info(info_d, solver_parameters)
        self.last_solve_info = info

        v = Function(space_v, name="v", data=u0[0])
        if inhom:
            v.data = v.data + v_inhom.data
        self.set_v(v)
        self.set_zeta(Function(space_v, name="zeta", data=u1[0]))
        return info

    # ------------------------------------------------------ not yet ported
    def non_linear_solve(self, *args, **kwargs):
        raise NotImplementedError(
            "the stationary nonlinear (Picard / Gauss-Newton) solve is not "
            "ported yet")

    def incompressible_linear_solve(self, *args, **kwargs):
        raise NotImplementedError(
            "the stationary incompressible (Stokes) solve is not ported yet")

    def incompressible_non_linear_solve(self, *args, **kwargs):
        raise NotImplementedError(
            "the stationary Navier-Stokes solve is not ported yet")
