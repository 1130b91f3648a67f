"""Shared machinery for the problem layer: per-block approximate solvers
(the reference's ``LinearSolver(assemble(form, bcs), solver_parameters)``
building blocks), the Picard operator and the refusals the problem classes
share."""

import torch

from ..fem.assemble import assemble
from ..fem.space import Function
from ..ops.local_op import LocalOp, MaskedOp
from ..ops.stencil import StencilOp, fused_cheb_smooth
from ..solvers.multigrid import MGConfig


def zero_rows(mask, b):
    """bc.apply on a dual vector with homogeneous bcs."""
    return torch.where(mask, 0.0, b) if mask is not None else b


class BlockSolver:
    """One application of an approximate block inverse.

    kind:
      ("mg", cycles)          -- 'preonly + boomeramg, max_iter=cycles'
      ("cheb", bounds, iters) -- 'chebyshev + jacobi' with spectral bounds
      ("jacobi",)             -- 'preonly + jacobi'
    Applies batched over arbitrary leading axes, on scalar and vector
    spaces, with a Dirichlet ``mask`` or none (the pressure space).
    ``state`` (as exposed by ``.state``) rebuilds the solver from previously
    derived tensors.
    """

    def __init__(self, op, mask, kind, state=None):
        self.kind = kind
        self.mask = mask
        self.op = MaskedOp(op, mask) if mask is not None else op
        inner = self.op.op if isinstance(self.op, MaskedOp) else self.op
        if kind[0] == "mg":
            self.config = MGConfig(inner.trial_space, mask)
            self.params = (self.config.build(inner.A) if state is None
                           else state)
            self.state = self.params
        elif state is None:
            self.op = StencilOp.from_local(self.op)
            d = self.op.diag()
            self.diag = torch.where(d == 0, 1.0, d)
            self.state = {"w": self.op.w, "diag": self.diag}
        else:
            self.op = StencilOp(inner.trial_space, state["w"])
            self.diag = state["diag"]
            self.state = state

    def __call__(self, b):
        if self.kind[0] == "mg":
            return self.config.apply(self.params, b, cycles=self.kind[1])
        if self.kind[0] == "cheb":
            # the krylov.chebyshev recurrence as one fused smoothing call
            # (kernel K2 on the card; K5 in 3-D; K4 / K5v on 2-D / 3-D
            # vector spaces)
            _, bounds, iters = self.kind
            theta = 0.5 * (bounds[1] + bounds[0])
            delta = 0.5 * (bounds[1] - bounds[0])
            core = self.op.nd + (0 if self.op.space.dim is None else 1)
            lead = tuple(b.shape[:b.dim() - core])
            grid = tuple(b.shape[b.dim() - core:])
            bf = b.reshape((-1,) + grid)
            x = fused_cheb_smooth(self.op.w, 1.0 / self.diag, bf,
                                  torch.zeros_like(bf), iters, theta,
                                  delta, self.op.degree, nd=self.op.nd)
            return x.reshape(lead + grid)
        return b / self.diag


def regularized_stiffness(K_op, M_op, eps=1.0e-6):
    """K + c*M with c = eps * max|diag K| / max|diag M|.

    The pressure stiffness of an enclosed-flow (pure-Neumann) problem is
    singular (constant nullspace), and the multigrid hierarchy ends in a
    dense coarse inverse, which a singular matrix makes meaningless.  A
    mass shift of relative size eps makes the coarse solve well-posed while
    perturbing the preconditioner only at O(eps)."""
    dK = torch.max(torch.abs(K_op.diag()))
    dM = torch.max(torch.abs(M_op.diag()))
    c = eps * dK / dM
    return LocalOp(K_op.A + c * M_op.A, K_op.trial_space, K_op.test_space)


def mass_solver(M_op, mask, multigrid_flag, lambda_bounds, state=None,
                steps=None):
    """The reference's (1,1)-block solver selection
    (control/control.py:356-394): BoomerAMG when Multigrid=True, Chebyshev
    semi-iteration with user bounds, else plain Jacobi.

    ``steps``: Chebyshev step count (the reference fixes 20,
    control/control.py:377-385); only the Chebyshev branch takes it."""
    if multigrid_flag:
        if steps is not None:
            raise ValueError(
                "set_mass_solver_steps configures the Chebyshev (1,1) "
                "solve and has no effect with Multigrid=True; unset it "
                "or drop the Multigrid flag")
        return BlockSolver(M_op, mask, ("mg", 2), state=state)
    if lambda_bounds is not None:
        return BlockSolver(M_op, mask,
                           ("cheb", tuple(lambda_bounds),
                            20 if steps is None else int(steps)),
                           state=state)
    return BlockSolver(M_op, mask, ("jacobi",), state=state)


def bc_lift_function(space, bcs):
    """Function equal to the (inhomogeneous) bc values on the boundary, 0
    inside (the reference's v_inhom; control/control.py:521-523)."""
    v = Function(space)
    for bc in bcs:
        v.data = torch.where(bc.mask, bc.g, v.data)
    return v


def tensor_token(t):
    """A hashable key for a tensor's value (None for None): the pc-state
    caches key on the linearisation state and the masks."""
    if t is None:
        return None
    return (tuple(t.shape), str(t.dtype), t.detach().cpu().numpy().tobytes())


def picard_operator(form):
    """Assemble a bilinear form (operator frozen at the current state) --
    the reference's construct_D_v without Gauss_Newton
    (control/control.py:314-317)."""
    return assemble(form)


def strip_refinement(solver_parameters):
    """``solver_parameters`` without the JAX package's refinement keys
    (``iterative_refinement``, ``refinement_inner_tolerance``).  As there,
    0 (or no) refinement steps is the plain solve and the inner tolerance
    is then ignored; one or more steps of its mixed-precision iterative
    refinement raise ``NotImplementedError`` (not ported)."""
    if solver_parameters is None:
        return None
    sp = dict(solver_parameters)
    steps = int(sp.pop("iterative_refinement", 0) or 0)
    sp.pop("refinement_inner_tolerance", None)
    if steps:
        raise NotImplementedError("iterative refinement is not ported yet")
    return sp
