"""Instationary (space-time all-at-once) optimal control problems, the
linear paths: heat control (``linear_solve``, Crank-Nicolson or, with
``CN=False``, backward Euler) and Crank-Nicolson Stokes control on a
velocity / pressure pair (``incompressible_linear_solve``).

The all-at-once vector over n_t time steps is a stacked tensor
(n_t, *grid); the block-bidiagonal space-time KKT operator becomes a
handful of batched contractions (one per block diagonal), and the
Crank-Nicolson T1/T2 symmetrisation is a pair of (alternating-)cumsums.

The built-in preconditioner reproduces the reference's recipe
(control/control.py:1943-2440): block-(1,1) mass solves vectorised over all
time blocks at once (kernel K2; K5 on 3-D meshes), and a matching-Schur
approximation

    S ~ (L + c M) M^{-1} (L^T + c M),   c = 0.5 tau / sqrt(beta)

whose forward/backward block substitutions run either exactly, one time
block after another with one multigrid V-cycle each ("scan", the default),
or all at once by ParaDiag: an alpha-circulant approximation diagonalised
by a time-axis DFT, with one batched complex V-cycle over the frequencies
(kernel K3; K5 in 3-D) and a defect correction (kernel K1; K6 in 3-D), or
as a truncated block-Jacobi iteration with all time blocks in one batched
V-cycle ("jacobi").  Everything is dimension-generic: the same code runs
Q1 quadrilaterals and hexahedra, and vector spaces with the sequential
sweeps.

Backward Euler (reference control/control.py:2191-2438) has n_t blocks, a
(1,1) block whose final diagonal block the pc regularises by eps (default
1e-3, ``set_epsilon``), and Schur factors with row-dependent shifts
[0, c, ..., c, sqrt(eps) c]: the edge rows peel off into exact
single-block V-cycles around an interior ParaDiag (``_BEParaDiagSweep``).
The pc runs Sigma-conjugated (Sigma = diag(1, ..., 1, eps)) and the Krylov
iteration on the eps-scaled final state block, so that every intermediate
stays O(1) in float32.

The incompressible solve nests this preconditioner: five fixed GMRES
iterations on the space-time velocity KKT system, preconditioned as above
on the vector space (mass solves and V-cycle smoothing: kernel K4, K5v on
hexahedra), and a
per-time-block pressure Schur part K_p^{-1} (KKT_p) M_p^{-1} with the
1/tau^2 scaling and the T sandwiches (the M_p solve: kernel K2).
"""

import numpy as np
import torch

from ..config import complex_dtype, full_precision
from ..fem.expr import (TrialFunction, TestFunction, Constant, inner, grad,
                        div)
from ..fem.forms import dx
from ..fem.space import (Function, MixedFunction, DirichletBC, homogenize,
                         combine_masks)
from ..fem.assemble import assemble
from ..ops.local_op import LocalOp
from ..ops.stencil import (node_stencil, apply_stencil,
                           weight_storage_dtype)
from ..solvers.block import (MultiBlockSystem, BlockAction,
                             DirichletBCNullspace, NoneNullspace, apply_T_1,
                             apply_T_2, apply_T_1_inv, apply_T_2_inv,
                             finalize_solve_info)
from ..solvers.multigrid import MGConfig, index_params, flip_params
from .common import (BlockSolver, mass_solver, regularized_stiffness,
                     zero_rows, bc_lift_function, strip_refinement,
                     tensor_token)


def _probe_form_dependence(form_fn, space, coeff_space, t_samples):
    """Whether the operator assembled from ``form_fn(trial, test, v, t)``
    (trial/test on ``space``, state coefficient ``v`` on ``coeff_space``)
    depends on the state ``v`` / the time ``t``.

    Expression-tree containment misses coefficients produced EAGERLY from
    ``v``/``t`` inside the user callback, so probe numerically: assemble at
    two state samples / two time samples and compare exactly.  A form whose
    assembled operators coincide at both samples is treated as
    independent."""
    trial = TrialFunction(space)
    test = TestFunction(space)
    t0, t1 = float(t_samples[0]), float(t_samples[1])

    def build(vdata, t):
        vfun = Function(coeff_space, data=vdata)
        out = assemble(form_fn(trial, test, vfun, Constant(t)))
        return out.A if hasattr(out, "A") else out.data

    z = coeff_space.zeros()
    # deterministic, smooth, non-constant probe state
    probe = torch.arange(z.numel(), dtype=z.dtype,
                         device=z.device).reshape(z.shape)
    probe = 0.5 + probe / max(z.numel() - 1, 1)
    A00 = build(z, t0)
    dep_v = not torch.equal(A00, build(probe, t0))
    dep_t = not torch.equal(A00, build(z, t1))
    return dep_v, dep_t


def _fast_stack_applier(space, A):
    """Batched stacked-operator application via the node-stencil path
    (kernel K1 on the card; K6 in 3-D; shifted multiply-adds with
    dim x dim coupling blocks on vector spaces)."""
    w = node_stencil(A, space)
    d, nd = space.degree, space.ndim
    return lambda x: apply_stencil(w, x, d, nd=nd)


class _SweepSolver:
    """Sequential solve of a block lower-bidiagonal system
    u_i = V-cycle_i(b_i - S_i u_{i-1}), one time block after another, with
    per-time-block multigrid hierarchies built once (batched when the
    blocks differ).  The sub-diagonal action is a node stencil (K1; K6 in
    3-D), the V-cycle smoothing real (K2; K5 in 3-D; K4 / K5v on vector
    spaces).  ``solve_jacobi`` runs the same substitution as a truncated
    block-Jacobi iteration with all time blocks in one batched V-cycle."""

    def __init__(self, space, mask, diag_A, sub_A, cycles=1, state=None):
        self.space, self.mask, self.cycles = space, mask, cycles
        self.config = MGConfig(space, mask)
        self.shared = diag_A.shape[0] == 1
        if state is not None:
            self.params = state["params"]
            self.sub = state["sub"]
        else:
            self.params = self.config.build(diag_A[0] if self.shared
                                            else diag_A)
            # (m|1, K, *grid), on vector spaces (m|1, K, *nodes, dim, dim)
            self.sub = node_stencil(sub_A, space)
        self.state = {"params": self.params, "sub": self.sub}

    def _oriented(self, b, reverse):
        """b, the hierarchies and the sub-diagonal stencils in the order of
        the sweep (a backward sweep runs the rows in reverse)."""
        params, sub = self.params, self.sub
        if reverse:
            b = torch.flip(b, (0,))
            if not self.shared:
                params = flip_params(params)
            if sub.shape[0] > 1:
                sub = torch.flip(sub, (0,))
        return b, params, sub

    def solve(self, b, reverse=False, last_sub_scale=1.0):
        """``last_sub_scale`` scales the coupling into the final row (the
        Sigma-conjugated backward-Euler factor); forward sweeps only."""
        if last_sub_scale != 1.0 and reverse:
            raise ValueError("last_sub_scale supports forward sweeps only")
        n = b.shape[0]
        b, params, sub = self._oriented(b, reverse)
        deg, nd = self.space.degree, self.space.ndim
        u_prev = None
        out = []
        for i in range(n):
            rhs = b[i]
            if i > 0:
                # row i couples to u_{i-1} through S_i (shared, or the
                # (i-1)-th entry of the per-row stack)
                S_i = sub[0] if sub.shape[0] == 1 else sub[i - 1]
                s = apply_stencil(S_i, u_prev, deg, nd=nd)
                if i == n - 1 and last_sub_scale != 1.0:
                    s = last_sub_scale * s
                rhs = rhs - s
            rhs = zero_rows(self.mask, rhs)
            p_i = params if self.shared else index_params(params, i)
            u_prev = self.config.apply(p_i, rhs, cycles=self.cycles)
            out.append(u_prev)
        u = torch.stack(out)
        return torch.flip(u, (0,)) if reverse else u

    def solve_jacobi(self, b, reverse=False, steps=12, last_sub_scale=1.0):
        """Truncated block-Jacobi substitution u^{m+1} = F^{-1}(b - S u^m),
        exact after n steps (S shifts by one block): every time block
        solves its V-cycle at once, as one batched smoothing call per level
        (K2 over n rows; K5 real in 3-D)."""
        if last_sub_scale != 1.0 and reverse:
            raise ValueError("last_sub_scale supports forward sweeps only")
        n = b.shape[0]
        steps = min(steps, n)
        b, params, sub = self._oriented(b, reverse)
        if sub.shape[0] > 1:
            sub = torch.cat([torch.zeros_like(sub[:1]), sub])
        deg, nd = self.space.degree, self.space.ndim
        mk = self.mask[None] if self.mask is not None else None

        def coupling(u):
            shifted = torch.cat([torch.zeros_like(u[:1]), u[:-1]])
            s = apply_stencil(sub, shifted, deg, nd=nd)
            if last_sub_scale != 1.0:
                s[n - 1] *= last_sub_scale
            return s

        u = self.config.apply(params, zero_rows(mk, b), cycles=self.cycles)
        for _ in range(steps - 1):
            u = self.config.apply(params, zero_rows(mk, b - coupling(u)),
                                  cycles=self.cycles)
        return torch.flip(u, (0,)) if reverse else u


class _ParaDiagSweep:
    """Parallel-in-time Schur substitution via ParaDiag: the block
    lower-bidiagonal Toeplitz factor (L + cM) is replaced by its
    alpha-circulant approximation

        C_alpha = I (x) F + Sigma_alpha (x) S,
        (Sigma_alpha)_{j,j-1} = 1, (Sigma_alpha)_{0,n-1} = alpha,

    which a scaled DFT along the time axis diagonalises:

        u = D_a^{-1} IDFT_t[(F + mu_k S)^{-1} DFT_t(D_a b)]_k,
        mu_k = alpha^{1/n} e^{-2 pi i k / n},  D_a = diag(alpha^{j/n}).

    The n sequential V-cycles collapse into ONE batched complex V-cycle
    over n//2+1 frequencies (Hermitian symmetry of the real input).  The
    D_a^{-1} unscaling amplifies frequency-solve errors by up to 1/alpha;
    one defect-correction step u <- u + P(b - L u) squares the error of an
    application.

    The frequency hierarchies are built as one real stencil pair per level
    (``MGConfig.build_pair``: W_F + mu_k W_S), which one smoothing call
    reads once for all frequencies; with a ``weight_dtype`` narrower than
    the problem's, and from a state carried from the JAX package, they
    are per-frequency planes (``MGConfig.build``)."""

    def __init__(self, space, mask, diag_A, sub_A, n, alpha=None,
                 cycles=2, state=None, defect_steps=1, smooth=None,
                 weight_dtype=None):
        if diag_A.shape[0] != 1:
            raise ValueError("ParaDiag requires a Toeplitz (time-"
                             "independent) sweep factor")
        self.space, self.mask = space, mask
        self.cycles, self.n = cycles, n
        self.defect_steps = defect_steps
        rdtype = diag_A.dtype
        self.alpha = 1e-3 if alpha is None else alpha
        # small coarse level: the dense coarse inverse is built per
        # frequency
        pre, post = smooth if smooth is not None else (8, 8)
        self.config = MGConfig(space, mask, coarse_max_dofs=600,
                               pre=pre, post=post,
                               weight_dtype=weight_dtype)
        self.trivial = n == 1
        if self.trivial:
            # one row (the interior of a 3-row backward-Euler sweep): one
            # real hierarchy, no coupling
            self.params = (self.config.build(diag_A[0]) if state is None
                           else self.config.store(state["params"]))
            self.state = {"params": self.params}
            return
        cdtype = complex_dtype(rdtype)
        dev = diag_A.device
        n_f = n // 2 + 1
        if state is None:
            k = np.arange(n_f)
            mu = torch.as_tensor(
                self.alpha ** (1.0 / n) * np.exp((-2j * np.pi / n) * k),
                dtype=cdtype, device=dev)
            S = sub_A[0].expand(diag_A.shape[1:])
            if weight_storage_dtype(weight_dtype, cdtype) is None:
                # every level's frequency blocks as one real stencil pair
                # W_F + mu_k W_S; level 0's pair is the exact bidiagonal
                # factor stencils of the defect correction (masked rows:
                # identity on the diagonal factor, zero on the
                # sub-diagonal)
                self.params = self.config.build_pair(diag_A[0], S, mu)
                self._wF = self.params["WF"][0]
                self._wS = self.params["WS"][0]
            else:
                # narrow planes: per-frequency hierarchies, stored narrow
                # (rounded as the JAX package rounds its complex planes)
                A_k = (diag_A[0].to(cdtype)[None]
                       + mu[:, None, None, None] * S.to(cdtype)[None])
                self.params = self.config.build(A_k)
                self._wF = node_stencil(diag_A[0], space, mask=mask)
                self._wS = node_stencil(S, space, mask=mask, alpha=0.0)
        else:
            # a state carried from the JAX package holds per-frequency full
            # planes; the port's own holds a stencil pair, or narrow planes
            self.params = self.config.store(state["params"])
            self._wF = state["wF"]
            self._wS = state["wS"]
        # the defect-correction stencils stay in full precision (the
        # reference's), whatever weight_dtype the V-cycles store
        self.state = {"params": self.params, "wF": self._wF,
                      "wS": self._wS}
        # time-axis DFT as small dense complex products (the reference's
        # choice: an FFT's rounding error is amplified by the 1/alpha
        # unscaling; n_t is at most a few hundred)
        j = np.arange(n)
        Wf = np.exp(-2j * np.pi * np.outer(np.arange(n_f), j) / n)
        d = np.full(n_f, 2.0)
        d[0] = 1.0
        if n % 2 == 0:
            d[-1] = 1.0
        Wb = (np.conj(Wf) * d[:, None]).T / n      # (n, n_f)
        self._Wf = torch.as_tensor(Wf, dtype=cdtype, device=dev)
        self._Wb = torch.as_tensor(Wb, dtype=cdtype, device=dev)

    def _circulant_solve(self, b):
        """One alpha-circulant solve in the forward (lower-bidiagonal)
        frame; b is already bc-zeroed."""
        n = self.n
        j = torch.arange(n, dtype=b.dtype, device=b.device) / n
        scale = (self.alpha ** j).reshape((n,) + (1,) * (b.dim() - 1))
        g = (b * scale).to(self._Wf.dtype)
        ghat = torch.einsum("kj,j...->k...", self._Wf, g)
        # one batched V-cycle over all frequencies (MGConfig.apply
        # broadcasts over the leading hierarchy/rhs batch axis)
        what = self.config.apply(self.params, ghat, cycles=self.cycles)
        u = torch.einsum("jk,k...->j...", self._Wb, what).real
        return u.to(b.dtype) / scale

    def _factor_apply(self, u):
        """Exact y_i = F u_i + S u_{i-1} (bc rows: identity)."""
        d, nd = self.space.degree, self.space.ndim
        y = apply_stencil(self._wF, u, d, nd=nd)
        y[1:] += apply_stencil(self._wS, u[:-1], d, nd=nd)
        return y

    def solve(self, b, reverse=False):
        mk = self.mask[None] if self.mask is not None else None
        if self.trivial:
            return self.config.apply(self.params, zero_rows(mk, b),
                                     cycles=self.cycles)
        if reverse:
            b = torch.flip(b, (0,))
        b = zero_rows(mk, b)
        u = self._circulant_solve(b)
        for _ in range(self.defect_steps):
            r = b - self._factor_apply(u)
            u = u + self._circulant_solve(r)
        u = zero_rows(mk, u)
        return torch.flip(u, (0,)) if reverse else u


class _BEParaDiagSweep:
    """Time-parallel backward-Euler Schur substitution (reference
    control/control.py:2191-2438).

    The BE sweep factor is block lower-bidiagonal with row-dependent
    diagonal shifts [0, c, ..., c, sqrt(eps) c] and a constant
    sub-diagonal S = -M: Toeplitz except in its first and last rows, which
    peel off into exact single-block solves around an interior ParaDiag:

        u_0       = F_0^{-1} b_0
        u_{1:n-1} = ParaDiag over the interior Toeplitz block with
                    rhs (b_1 - S u_0, b_2, ..., b_{n-2})
        u_{n-1}   = F_{n-1}^{-1} (b_{n-1} - S u_{n-2})

    The edge solves are V-cycles of a default ``MGConfig`` hierarchy on
    one block (K2; K5 real in 3-D), the interior a batched complex V-cycle
    over its frequencies (K3; K5 complex), the coupling a node stencil
    (K1; K6).  ``reverse=True`` flips the row order (the backward
    factor's edge shifts swap ends), so one instance serves the
    (L^T + shifts) sweep too."""

    def __init__(self, space, mask, diag_A, sub_A, n, alpha=None,
                 cycles=2, state=None, defect_steps=1, smooth=None,
                 weight_dtype=None):
        if diag_A.shape[0] != n or n < 3:
            raise ValueError("edge-row ParaDiag needs the full "
                             "row-dependent factor stack with n >= 3 rows")
        self.space, self.mask, self.n = space, mask, n
        self.cycles = cycles
        self.edge_config = MGConfig(space, mask)
        if state is None:
            e_first = self.edge_config.build(diag_A[0])
            e_last = self.edge_config.build(diag_A[n - 1])
            wS = node_stencil(sub_A, space)
            mid_state = None
        else:
            e_first, e_last = state["e_first"], state["e_last"]
            wS = state["wS"]
            mid_state = state["mid"]
        self.e_first, self.e_last, self._wS = e_first, e_last, wS
        self.mid = _ParaDiagSweep(space, mask, diag_A[1:2], sub_A, n - 2,
                                  alpha=alpha, cycles=cycles,
                                  defect_steps=defect_steps, smooth=smooth,
                                  weight_dtype=weight_dtype,
                                  state=mid_state)
        self.state = {"e_first": e_first, "e_last": e_last, "wS": wS,
                      "mid": self.mid.state}

    def solve(self, b, reverse=False, last_sub_scale=1.0):
        if last_sub_scale != 1.0 and reverse:
            raise ValueError("last_sub_scale supports forward sweeps only")
        mk = self.mask[None] if self.mask is not None else None
        if reverse:
            b = torch.flip(b, (0,))
        b = zero_rows(mk, b)
        first = self.e_last if reverse else self.e_first
        last = self.e_first if reverse else self.e_last
        d, nd = self.space.degree, self.space.ndim
        u0 = self.edge_config.apply(first, b[0], cycles=self.cycles)
        bm = b[1:-1].clone()
        bm[0] -= apply_stencil(self._wS[0], u0, d, nd=nd)
        um = self.mid.solve(zero_rows(mk, bm))
        s_ul = apply_stencil(self._wS[0], um[-1], d, nd=nd)
        bl = zero_rows(self.mask, b[-1] - last_sub_scale * s_ul)
        ul = self.edge_config.apply(last, bl, cycles=self.cycles)
        u = zero_rows(mk, torch.cat([u0[None], um, ul[None]]))
        return torch.flip(u, (0,)) if reverse else u


class Instationary:
    """See module docstring; API mirrors the reference
    (control/control.py:1489-1493).  Both ``force_f`` (documented name) and
    ``force_function`` are accepted.  Tensors follow the space's mesh
    ``device`` and ``dtype``."""

    def __init__(self, space_v, forward_form, desired_state=None,
                 force_f=None, *, beta=10.0**-3, space_p=None,
                 Gauss_Newton=False, CN=True, n_t=20,
                 initial_condition=None, time_interval=None, bcs_v=None,
                 force_function=None):
        if force_f is None:
            force_f = force_function
        if desired_state is None:
            def desired_state(test_v, t):
                v_d = Function(space_v, name="v_d")
                return inner(v_d, test_v) * dx, v_d
        if force_f is None:
            def force_f(test_v, t):
                f = Function(space_v, name="f")
                return inner(f, test_v) * dx

        self._space_v = space_v
        self._space_p = None
        self._M_p = None
        self._forward_form = forward_form
        self._desired_state = desired_state
        self._force_function = force_f
        self._beta = beta
        self._initial_condition = initial_condition
        self._time_interval = ((0.0, 1.0) if time_interval is None
                               else time_interval)
        self._CN = CN
        self._n_t = n_t
        self._Gauss_Newton = Gauss_Newton

        v_test, v_trial = TestFunction(space_v), TrialFunction(space_v)
        self._M_v = inner(v_trial, v_test) * dx

        self._f_bcs_v = bcs_v
        self._rebuild_bcs()

        v = MixedFunction(space_v, n_t, name="v")
        for i in range(n_t):
            for bc in self._bcs_v[i]:
                bc.apply(v.sub(i))
        self._v = v
        self._zeta = MixedFunction(space_v, n_t, name="zeta")
        if space_p is not None:
            self.set_space_p(space_p)
        self._true_v = None
        self._data_cache = {}
        self._pc_state_cache = {}

    # ------------------------------------------------------------- plumbing
    @property
    def _tau(self):
        t_0, T_f = self._time_interval
        return (T_f - t_0) / (self._n_t - 1.0)

    def _times(self):
        t_0, T_f = self._time_interval
        return np.linspace(t_0, T_f, self._n_t)

    def _rebuild_bcs(self):
        full = {}
        if self._f_bcs_v is None:
            for i in range(self._n_t):
                full[i] = ()
        else:
            for i, t in enumerate(self._times()):
                bcs_i = self._f_bcs_v(self._space_v, float(t))
                if isinstance(bcs_i, DirichletBC):
                    full[i] = (bcs_i,)
                else:
                    full[i] = tuple(bcs_i)
        self._bcs_v = full
        self._bc_stack_cache = None

    # -------------------------------------------------------------- setters
    def set_forward_form(self, forward_form):
        self._forward_form = forward_form
        self._dep_cache = None

    def set_desired_state(self, desired_state):
        self._desired_state = desired_state
        self._data_cache = {}

    def set_force_function(self, force_function):
        self._force_function = force_function
        self._data_cache = {}

    def set_beta(self, beta):
        self._beta = beta

    def set_initial_condition(self, initial_condition):
        self._initial_condition = initial_condition
        self._v.sub(0).assign(initial_condition(TestFunction(self._space_v)))
        for bc in self._bcs_v[0]:
            bc.apply(self._v.sub(0))

    def set_time_interval(self, time_interval):
        self._time_interval = time_interval
        self._rebuild_bcs()

    def set_CN(self, *, CN=True):
        """Switch between Crank-Nicolson and backward Euler (the pressure
        stacks of the incompressible problems change length)."""
        if CN != self._CN:
            self._CN = CN
            if self._space_p is not None:
                self.set_space_p(self._space_p)

    def set_n_t(self, n_t):
        """A new number of time steps: the bcs, v (with the initial
        condition) and zeta are rebuilt at the new length."""
        self._n_t = n_t
        self._rebuild_bcs()
        v = MixedFunction(self._space_v, n_t, name="v")
        if self._initial_condition is not None:
            v.sub(0).assign(self._initial_condition(
                TestFunction(self._space_v)))
        for i in range(n_t):
            for bc in self._bcs_v[i]:
                bc.apply(v.sub(i))
        self._v = v
        self._zeta = MixedFunction(self._space_v, n_t, name="zeta")
        if self._space_p is not None:
            self.set_space_p(self._space_p)

    def set_space_v(self, space_v, *, v=None, zeta=None, bcs_v_new=False,
                    bcs_v=None):
        """Replace the state space (reference control.py:1599-1671):
        rebuild the mass form and the per-time-step bcs, and carry the
        current state and adjoint over by interpolation onto the new space
        (e.g. after a mesh refinement)."""
        old_v, old_zeta = self._v, self._zeta
        old_space = old_v.space
        self._space_v = space_v
        v_test, v_trial = TestFunction(space_v), TrialFunction(space_v)
        self._M_v = inner(v_trial, v_test) * dx
        if bcs_v_new:
            self._f_bcs_v = bcs_v
        self._rebuild_bcs()
        n_t = self._n_t
        if v is None:
            v = MixedFunction(space_v, n_t, name="v")
            if self._initial_condition is not None:
                v.sub(0).assign(self._initial_condition(v_test))
            for i in range(1, n_t):
                v.sub(i).interpolate(
                    Function(old_space, data=old_v.data[i]))
        elif v.space != space_v or v.n != n_t:
            raise ValueError("Unexpected space")
        for i in range(n_t):
            for bc in self._bcs_v[i]:
                bc.apply(v.sub(i))
        if zeta is None:
            zeta = MixedFunction(space_v, n_t, name="zeta")
            for i in range(1, n_t):
                zeta.sub(i).interpolate(
                    Function(old_space, data=old_zeta.data[i]))
        elif zeta.space != space_v or zeta.n != n_t:
            raise ValueError("Unexpected space")
        self._v, self._zeta = v, zeta
        self._zero_zeta_bcs()
        self._data_cache = {}

    def set_bcs_v(self, bcs_v, space_v=None):
        if space_v is not None:
            self.set_space_v(space_v, bcs_v_new=True, bcs_v=bcs_v)
            return
        self._f_bcs_v = bcs_v
        self._rebuild_bcs()
        for i in range(self._n_t):
            for bc in self._bcs_v[i]:
                bc.apply(self._v.sub(i))
        self._zero_zeta_bcs()

    def set_Gauss_Newton(self, Gauss_Newton=True):
        """Only stores the flag: the Gauss-Newton linearisation itself is
        not ported and raises where it would be used."""
        self._Gauss_Newton = Gauss_Newton

    def set_epsilon(self, epsilon):
        """Backward-Euler final-time-block regularisation (the reference
        hardcodes epsilon = 1e-3, control/control.py:2836: the BE (1,1)
        block has a zero final diagonal block, so the pc substitutes
        eps * tau * M for it).  None restores the default."""
        if self._CN and epsilon is not None:
            raise ValueError("epsilon applies to backward Euler only")
        if epsilon is None:
            self.__dict__.pop("_be_epsilon", None)
        else:
            eps = float(epsilon)
            if not 0.0 < eps <= 1.0:
                raise ValueError("epsilon must lie in (0, 1]")
            self._be_epsilon = eps

    def _bc_stack(self):
        """Stacked (mask, value) tensors of the per-time-step Dirichlet
        bcs (cached; rebuilt when ``self._bcs_v`` is replaced)."""
        key = id(self._bcs_v)
        ent = getattr(self, "_bc_stack_cache", None)
        if ent is not None and ent[0] == key:
            return ent[1]
        sp = self._space_v
        mk = torch.zeros((self._n_t,) + sp.grid_shape, dtype=torch.bool,
                         device=sp.device)
        val = sp.zeros(self._n_t)
        for i in range(self._n_t):
            for bc in self._bcs_v[i]:
                mk[i] |= bc.mask
                val[i] = torch.where(bc.mask, bc.g, val[i])
        self._bc_stack_cache = (key, (mk, val))
        return mk, val

    def set_space_p(self, space_p, *, p=None, mu=None):
        """The pressure space of the incompressible problems, with the
        pressure ``p`` and its adjoint ``mu`` (one block per time step
        after the first)."""
        self._space_p = space_p
        p_test, p_trial = TestFunction(space_p), TrialFunction(space_p)
        self._M_p = inner(p_trial, p_test) * dx
        n_p = self._n_t if not self._CN else self._n_t - 1
        self._p = p if p is not None else MixedFunction(space_p, n_p,
                                                        name="p")
        self._mu = mu if mu is not None else MixedFunction(space_p, n_p,
                                                           name="mu")

    def set_v(self, v_new):
        self._v.assign(v_new)
        mk, val = self._bc_stack()
        self._v.data = torch.where(mk, val, self._v.data)

    def set_zeta(self, zeta_new):
        self._zeta.assign(zeta_new)
        self._zero_zeta_bcs()

    def _zero_zeta_bcs(self):
        bcs_zeta = homogenize(self._bcs_v[1])
        if bcs_zeta:
            mask = combine_masks(self._space_v, bcs_zeta)
            self._zeta.data = torch.where(mask[None], 0.0, self._zeta.data)

    def set_p(self, p_new):
        if self._space_p is None:
            raise ValueError("Undefined space_p: unable to assign value")
        self._p.assign(p_new)

    def set_mu(self, mu_new):
        if self._space_p is None:
            raise ValueError("Undefined space_p: unable to assign value")
        self._mu.assign(mu_new)

    def print_error(self, tau=None):
        if tau is None:
            tau = self._tau
        err2 = 0.0
        for i in range(self._n_t):
            d = Function(self._space_v,
                         data=self._true_v.data[i] - self._v.data[i])
            err2 = err2 + assemble(inner(d, d) * dx)
        e = float(np.sqrt(tau) * np.sqrt(abs(float(err2))))
        print(f"Estimated error in the L2-norm: {e:.16e}")

    # ----------------------------------------------------------- operators
    def construct_D_v(self, v_state, t):
        """LocalOp of the linearised forward operator at (v_state, t)
        (reference control/control.py:1887-1896)."""
        if self._Gauss_Newton:
            raise NotImplementedError(
                "the Gauss-Newton linearisation is not ported yet")
        trial = TrialFunction(self._space_v)
        test = TestFunction(self._space_v)
        return assemble(self._forward_form(trial, test, v_state,
                                           Constant(t)))

    def _probe_dependence(self):
        """Whether the forward form depends on the state / time (numeric
        probe; see _probe_form_dependence)."""
        cached = getattr(self, "_dep_cache", None)
        key = (id(self._forward_form), self._time_interval)
        if cached is not None and cached[0] == key:
            return cached[1]
        dep = _probe_form_dependence(
            self._forward_form, self._space_v, self._space_v,
            (self._time_interval[0],
             self._time_interval[0]
             + 0.618 * (self._time_interval[1] - self._time_interval[0])))
        self._dep_cache = (key, dep)
        return dep

    def _D_stack(self, v_old_data):
        """Stacked local matrices (n_t|1, E|1, b, a) of D_v at all time
        points; one assembly when the form depends on neither the state nor
        the time."""
        dep_v, dep_t = self._probe_dependence()
        if not dep_v and not dep_t:
            A = self.construct_D_v(Function(self._space_v),
                                   float(self._time_interval[0])).A
            return A[None]
        mats = [self.construct_D_v(Function(self._space_v, data=v_old_data[i]),
                                   float(t)).A
                for i, t in enumerate(self._times())]
        E = max(a.shape[0] for a in mats)
        return torch.stack([a.expand((E,) + tuple(a.shape[1:]))
                            for a in mats])

    # -------------------------------------------------------- data vectors
    def _data_cache_get(self, kind, key, build):
        ent = self._data_cache.get(kind)
        if ent is None or ent[0] != key:
            ent = (key, build())
            self._data_cache[kind] = ent
        return ent[1]

    def construct_f(self, v_test=None):
        """Stacked force vector (reference control/control.py:1898-1916)."""
        key = (id(self._force_function), self._n_t, self._time_interval,
               id(self._space_v), id(v_test))

        def build():
            vt = v_test if v_test is not None \
                else TestFunction(self._space_v)
            f = MixedFunction(self._space_v, self._n_t, dual=True,
                              name="f")
            f.data = torch.stack([
                assemble(self._force_function(vt, Constant(float(t)))).data
                for t in self._times()])
            return f

        return self._data_cache_get("f", key, build)

    def construct_v_d(self, v_test=None):
        key = (id(self._desired_state), self._n_t, self._time_interval,
               id(self._space_v), id(v_test))

        def build():
            vt = v_test if v_test is not None \
                else TestFunction(self._space_v)
            v_d = MixedFunction(self._space_v, self._n_t, dual=True,
                                name="v_d")
            true_v = MixedFunction(self._space_v, self._n_t, name="true_v")
            vds, tvs = [], []
            for t in self._times():
                v_d_i, true_v_i = self._desired_state(vt,
                                                      Constant(float(t)))
                vds.append(assemble(v_d_i).data)
                tvs.append(Function(self._space_v).assign(true_v_i).data)
            v_d.data = torch.stack(vds)
            true_v.data = torch.stack(tvs)
            return (v_d, true_v)

        v_d, true_v = self._data_cache_get("v_d", key, build)
        self._true_v = true_v
        return v_d

    def _initial_state(self):
        if self._initial_condition is not None:
            v0 = self._initial_condition(TestFunction(self._space_v))
            return Function(self._space_v, data=v0.data)
        return Function(self._space_v, name="v_0")

    # ------------------------------------------------------- block building
    def _blocks(self, Dv_A, M=None, space=None):
        """Block dicts of the all-at-once KKT operator (reference
        control/control.py:2889-2978): n_t x n_t blocks under backward
        Euler, n_t - 1 under Crank-Nicolson; on the velocity space or,
        with the stacked operator and the mass operator of another
        ``space``, on that one (the pressure space of the Schur
        approximation)."""
        n_t, tau, beta = self._n_t, self._tau, self._beta
        sp = self._space_v if space is None else space
        if M is None:
            M = assemble(self._M_v)
        M_A = M.A                                   # (1|E, b, a)

        def D(i):
            return Dv_A[0] if Dv_A.shape[0] == 1 else Dv_A[i]

        def DT(i):
            return D(i).transpose(-1, -2)

        def op(A):
            return LocalOp(A, sp, sp)

        block_00, block_01, block_10, block_11 = {}, {}, {}, {}
        if not self._CN:
            sh = Dv_A.shape[0] == 1
            d01 = op(tau * DT(0) + M_A) if sh else None
            d10 = op(tau * D(0) + M_A) if sh else None
            mM = op(-M_A)
            tbM = op(-(tau / beta) * M_A)
            tM = op(tau * M_A)
            for i in range(n_t):
                if i < n_t - 1:
                    block_00[(i, i)] = tM
                    block_01[(i, i + 1)] = mM
                block_01[(i, i)] = d01 or op(tau * DT(i) + M_A)
                block_10[(i, i)] = d10 or op(tau * D(i) + M_A)
                if i >= 1:
                    block_10[(i, i - 1)] = mM
                    block_11[(i, i)] = tbM
            return block_00, block_01, block_10, block_11, M
        n = n_t - 1
        hM = op(0.5 * tau * M_A)
        hbM = op(-0.5 * (tau / beta) * M_A)
        sh = Dv_A.shape[0] == 1
        d01 = op(0.5 * tau * DT(0) + M_A) if sh else None
        d01m = op(0.5 * tau * DT(0) - M_A) if sh else None
        d10 = op(0.5 * tau * D(0) + M_A) if sh else None
        d10m = op(0.5 * tau * D(0) - M_A) if sh else None
        for i in range(n):
            block_00[(i, i)] = hM
            if i >= 1:
                block_00[(i, i - 1)] = hM
            block_01[(i, i)] = d01 or op(0.5 * tau * DT(i) + M_A)
            if i < n - 1:
                block_01[(i, i + 1)] = d01m or op(
                    0.5 * tau * DT(i + 1) - M_A)
            block_10[(i, i)] = d10 or op(0.5 * tau * D(i + 1) + M_A)
            if i >= 1:
                block_10[(i, i - 1)] = d10m or op(0.5 * tau * D(i) - M_A)
            block_11[(i, i)] = hbM
            if i < n - 1:
                block_11[(i, i + 1)] = hbM
        return block_00, block_01, block_10, block_11, M

    # ------------------------------------------------------- preconditioner
    def _sweep_fn(self, mode):
        """How a sweep solver runs: ``sweep(solver, b, reverse,
        last_sub_scale=1.0)``, the exact substitution or, in the "jacobi"
        mode, the truncated block-Jacobi one."""
        if mode == "jacobi":
            k = getattr(self, "_schur_jacobi_steps", None) or 12
            return lambda solver, b, rev, ls=1.0: solver.solve_jacobi(
                b, reverse=rev, steps=k, last_sub_scale=ls)
        return lambda solver, b, rev, ls=1.0: solver.solve(
            b, reverse=rev, last_sub_scale=ls)

    def _make_sweeps(self, space, mask, F_diag, F_sub, G_diag, G_sup, n,
                     toeplitz_factors=None, prebuilt=None, edge_rows=False):
        """Build the forward/backward Schur substitution solvers for the
        selected mode and return ``(fwd, bwd, sweep)``, ``sweep`` as in
        ``_sweep_fn``.  ParaDiag applies when both factors are Toeplitz (a
        time-independent operator: one diagonal factor for all rows), or
        through ``toeplitz_factors=(F_toep, G_toep)``, a caller's Toeplitz
        approximation of row-dependent factors.  ``edge_rows=True`` says
        the n-row factor stacks are Toeplitz but for their first and last
        rows (the backward-Euler shifts): those peel off into exact
        single-block solves around an interior ParaDiag
        (``_BEParaDiagSweep``).  Otherwise the exact sequential sweep runs,
        whatever the mode (or the block-Jacobi one, when asked for)."""
        mode = getattr(self, "_schur_mode", "scan")
        parallel = mode in ("auto", "paradiag") and n > 1
        edge = parallel and edge_rows and n >= 3 and F_diag.shape[0] == n
        if F_diag.shape[0] == 1 and G_diag.shape[0] == 1:
            toeplitz_factors = (F_diag, G_diag)
        circulant = parallel and toeplitz_factors is not None
        if (edge or circulant) and space.dim is not None:
            raise NotImplementedError(
                "ParaDiag sweeps on vector spaces (complex vector "
                "smoothing) are not ported yet; use the scan sweeps")
        kw = dict(alpha=getattr(self, "_paradiag_alpha", None),
                  defect_steps=getattr(self, "_paradiag_dc", 1),
                  cycles=getattr(self, "_paradiag_cycles", 2),
                  smooth=getattr(self, "_mg_smooth", None),
                  weight_dtype=getattr(self, "_mg_weight_dtype", None))

        def state(key):
            return None if prebuilt is None else prebuilt[key]

        if edge:
            fwd = _BEParaDiagSweep(space, mask, F_diag, F_sub, n,
                                   state=state("fwd"), **kw)
            bwd = _BEParaDiagSweep(space, mask, G_diag, G_sup, n,
                                   state=state("bwd"), **kw)
            return fwd, bwd, self._sweep_fn("scan")
        if circulant:
            F_t, G_t = toeplitz_factors
            fwd = _ParaDiagSweep(space, mask, F_t, F_sub, n,
                                 state=state("fwd"), **kw)
            bwd = _ParaDiagSweep(space, mask, G_t, G_sup, n,
                                 state=state("bwd"), **kw)

            def toeplitz_sweep(solver, b, rev, ls=1.0):
                if ls != 1.0:
                    raise ValueError("last_sub_scale needs row-resolved "
                                     "sweep factors")
                return solver.solve(b, reverse=rev)

            return fwd, bwd, toeplitz_sweep
        fwd = _SweepSolver(space, mask, F_diag, F_sub, state=state("fwd"))
        bwd = _SweepSolver(space, mask, G_diag, G_sup, state=state("bwd"))
        return fwd, bwd, self._sweep_fn(
            "scan" if mode in ("auto", "paradiag") else mode)

    def set_schur_sweep(self, mode, steps=None, paradiag_alpha=None,
                        paradiag_defect_steps=None, paradiag_cycles=None,
                        smooth=None, weight_dtype=None):
        """Select the Schur substitution strategy ("scan" | "jacobi" |
        "paradiag" | "auto"), optionally fixing the Jacobi step count
        (default 12), the ParaDiag circulant parameter alpha, the number
        of ParaDiag defect-correction steps (default 1), the V-cycle count
        of the per-frequency solves (default 2), the (pre, post) Chebyshev
        smoothing step counts of the ParaDiag frequency V-cycles (default
        (8, 8)), or the storage dtype of the ParaDiag smoothers' weight
        planes (e.g. "bfloat16": the narrow K3/K5 kernels on the card)."""
        if mode not in ("scan", "jacobi", "paradiag", "auto"):
            raise ValueError(f"unknown Schur sweep {mode!r}")
        self._schur_mode = mode
        self._schur_jacobi_steps = steps
        self._paradiag_alpha = paradiag_alpha
        if paradiag_defect_steps is not None:
            self._paradiag_dc = paradiag_defect_steps
        if paradiag_cycles is not None:
            self._paradiag_cycles = paradiag_cycles
        if smooth is not None:
            self._mg_smooth = (int(smooth[0]), int(smooth[1]))
        if weight_dtype is not None:
            self._mg_weight_dtype = str(weight_dtype)

    def set_mass_solver_steps(self, steps):
        """Chebyshev step count of the preconditioner's (1,1)-block mass
        solves (the reference fixes 20, control/control.py:377-385)."""
        self._mass_cheb_steps = None if steps is None else int(steps)

    def construct_pc(self, Multigrid, lambda_v_bounds, mask, Dv_A, M,
                     epsilon=None, prebuilt=None):
        """The reference's CN / BE block preconditioner
        (control/control.py:1943-2440), with the (1,1) mass solves batched
        over all time blocks; ``epsilon`` is backward Euler's final-block
        regularisation.

        The returned callable carries a ``.state`` dict of every tensor it
        derived (multigrid hierarchies, stencils, coarse inverses).  Passing
        that dict back via ``prebuilt=`` rebuilds an identical pc without
        re-deriving the state."""
        M_A = M.A
        solver_0 = mass_solver(M, mask, Multigrid, lambda_v_bounds,
                               state=None if prebuilt is None
                               else prebuilt["solver_0"],
                               steps=getattr(self, "_mass_cheb_steps",
                                             None))
        if not self._CN:
            return self._construct_pc_be(solver_0, mask, Dv_A, M_A, epsilon,
                                         prebuilt)
        n_t, tau, beta = self._n_t, self._tau, self._beta
        sp = self._space_v
        sh = Dv_A.shape[0] == 1
        n = n_t - 1
        c = 0.5 * tau / beta ** 0.5
        # lower-bidiagonal action stacks (raw block_10)
        if sh:
            d10_diag = (0.5 * tau * Dv_A[0] + M_A)[None]
            d10_sub = (0.5 * tau * Dv_A[0] - M_A)[None]
        else:
            d10_diag = 0.5 * tau * Dv_A[1:n + 1] + M_A
            d10_sub = 0.5 * tau * Dv_A[1:n] - M_A
        # Schur sweep operators (+ cM)
        F_diag = d10_diag + c * M_A
        F_sub = d10_sub + c * M_A
        if sh:
            DT0 = Dv_A[0].transpose(-1, -2)
            G_diag = (0.5 * tau * DT0 + M_A + c * M_A)[None]
            G_sup = (0.5 * tau * DT0 - M_A + c * M_A)[None]
        else:
            G_diag = (0.5 * tau * Dv_A[:n].transpose(-1, -2)
                      + M_A + c * M_A)
            G_sup = (0.5 * tau * Dv_A[1:n].transpose(-1, -2)
                     - M_A + c * M_A)
        fwd, bwd, sweep = self._make_sweeps(sp, mask, F_diag, F_sub, G_diag,
                                            G_sup, n, prebuilt=prebuilt)
        ap_diag = _fast_stack_applier(sp, d10_diag)
        ap_sub = _fast_stack_applier(sp, d10_sub)
        ap_M = _fast_stack_applier(sp, M_A[None])
        mk = mask[None] if mask is not None else None

        def pc_linear(b_0, b_1):
            # (1,1)-block: u0 = T2^{-1} (2/tau) M^{-1} T1^{-1} b0
            u_0 = apply_T_1_inv(b_0)
            u_0 = (2.0 / tau) * solver_0(u_0)
            u_0 = apply_T_2_inv(u_0)
            # b = block_10 u0 (rowwise bcs), T2, -b1, bcs, T2^{-1}
            b = ap_diag(u_0)
            b[1:] += ap_sub(u_0[:-1])
            b = zero_rows(mk, b)
            b = apply_T_2(b)
            b = b - b_1
            b = zero_rows(mk, b)
            b = apply_T_2_inv(b)
            # forward substitution (L + cM)
            u_1 = sweep(fwd, b, False)
            u_1 = apply_T_2(u_1)
            # multiply 0.5 tau M
            b = 0.5 * tau * ap_M(u_1)
            b = zero_rows(mk, b)
            # backward substitution (L^T + cM)
            u_1 = sweep(bwd, b, True)
            return u_0, u_1

        pc_linear.state = {"solver_0": solver_0.state,
                           "fwd": fwd.state, "bwd": bwd.state}
        return pc_linear

    def _construct_pc_be(self, solver_0, mask, Dv_A, M_A, epsilon,
                         prebuilt):
        """The backward-Euler block preconditioner (reference
        control/control.py:2191-2438) over n_t blocks: the mass solve, then
        the Schur factors with diagonal shifts [0, c, ..., c, sqrt(eps) c]
        and sub-diagonal -M, swept forward and backward (edge-row ParaDiag
        for a time-independent operator in the ParaDiag modes, the exact
        or block-Jacobi sweep otherwise)."""
        n, tau, beta = self._n_t, self._tau, self._beta
        sp = self._space_v
        sh = Dv_A.shape[0] == 1
        c = tau / beta ** 0.5
        eps = float(epsilon)
        s_f = torch.tensor([0.0] + [c] * (n - 2) + [(eps ** 0.5) * c],
                           dtype=Dv_A.dtype, device=Dv_A.device)
        shift_M = s_f[:, None, None, None] * M_A
        if sh:
            d10_diag = (tau * Dv_A[0] + M_A)[None]
            G_diag = (tau * Dv_A[0].transpose(-1, -2) + M_A)[None] + shift_M
        else:
            d10_diag = tau * Dv_A + M_A
            G_diag = tau * Dv_A.transpose(-1, -2) + M_A + shift_M
        F_diag = d10_diag + shift_M
        mM = (-M_A)[None]
        # a uniform-shift Toeplitz approximation of these factors doubles
        # the outer iterations (the zero first-row shift matters), so a
        # time-independent operator peels the edge rows off instead
        fwd, bwd, sweep = self._make_sweeps(sp, mask, F_diag, mM, G_diag, mM,
                                            n, prebuilt=prebuilt,
                                            edge_rows=sh and n >= 3)
        ap_diag = _fast_stack_applier(sp, d10_diag)
        ap_sub = _fast_stack_applier(sp, mM)
        ap_M = _fast_stack_applier(sp, M_A[None])
        mk = mask[None] if mask is not None else None

        def pc_linear(b_0, b_1):
            # The reference amplifies the final (1,1) block by 1/eps and
            # rescales by eps after the forward sweep
            # (control/control.py:2205-2206,2312,2348,2358).  Conjugating
            # the Schur chain by Sigma = diag(1, ..., 1, eps) over the time
            # blocks is the same algebra with every intermediate O(1):
            #   b^  = (Sigma B Sigma^-1) u~0 - Sigma b_1,
            #   u^1 = (Sigma F Sigma^-1)^-1 b^   [= Sigma u_1],
            #   b2  = tau M u^1                  [= the eps-scaled rhs],
            # where u~0 is the unamplified mass solve and the conjugated
            # operators scale the sub-diagonal coupling into the final row
            # by eps (last_sub_scale); 1/eps comes back only on the
            # returned final (1,1) block.
            u_0 = (1.0 / tau) * solver_0(b_0)
            b = ap_diag(u_0)
            sub = ap_sub(u_0[:-1])
            sub[n - 2] *= eps
            b[1:] += sub
            b_1 = b_1.clone()
            b_1[n - 1] *= eps
            b = zero_rows(mk, b - b_1)
            u_1 = sweep(fwd, b, False, eps)
            # multiply tau M; the final block is already eps-scaled
            b = zero_rows(mk, tau * ap_M(u_1))
            u_1 = sweep(bwd, b, True)
            u_0 = u_0.clone()
            u_0[n - 1] *= 1.0 / eps
            return u_0, u_1

        pc_linear.state = {"solver_0": solver_0.state,
                           "fwd": fwd.state, "bwd": bwd.state}
        return pc_linear

    # ------------------------------------------------------------ rhs build
    def _build_rhs(self, v_d, f, v_0, Dv_A, M, mask, inhom, bcs_v_help):
        """All-at-once rhs incl. initial-condition and inhomogeneous-bc
        lifts (reference control/control.py:2980-3243).  Returns stacked
        (b_0, b_1).  Under Crank-Nicolson the T1/T2 symmetrisation is
        applied unconditionally, also to caller-supplied rhs (reference
        control/control.py:3242-3243); backward Euler has none."""
        n_t, tau = self._n_t, self._tau
        sp = self._space_v
        sh = Dv_A.shape[0] == 1

        def D_op(i):
            return LocalOp(Dv_A[0] if sh else Dv_A[i], sp, sp)

        def lift(i):
            return bc_lift_function(sp, bcs_v_help[i]).data

        mk = mask[None] if mask is not None else None
        if not self._CN:
            return self._build_rhs_be(v_d, f, v_0, M, mk, inhom, D_op, lift)
        n = n_t - 1
        if v_d is not None:
            b_0 = apply_T_1(v_d.data)
        else:
            vd = self.construct_v_d().data
            b_0 = 0.5 * tau * (vd[:-1] + vd[1:])
            if inhom:
                for i in range(n):
                    b_0[i] += -0.5 * tau * M.apply(lift(i + 1))
                    if i > 0:
                        b_0[i] += -0.5 * tau * M.apply(lift(i))
            b_0[0] += -0.5 * tau * M.apply(v_0.data)
            b_0 = zero_rows(mk, b_0)
            b_0 = apply_T_1(b_0)
        if f is not None:
            b_1 = apply_T_2(f.data)
        else:
            ff = self.construct_f().data
            b_1 = 0.5 * tau * (ff[:-1] + ff[1:])
            if inhom:
                for i in range(n):
                    li1 = lift(i + 1)
                    b_1[i] += -(0.5 * tau * D_op(i + 1).apply(li1)
                                + M.apply(li1))
                    if i > 0:
                        li = lift(i)
                        b_1[i] += -(0.5 * tau * D_op(i).apply(li)
                                    - M.apply(li))
            D0 = self.construct_D_v(v_0, self._time_interval[0])
            b_1[0] += -(0.5 * tau * D0.apply(v_0.data)
                        - M.apply(v_0.data))
            b_1 = zero_rows(mk, b_1)
            b_1 = apply_T_2(b_1)
        return b_0, b_1

    def _build_rhs_be(self, v_d, f, v_0, M, mk, inhom, D_op, lift):
        """The backward-Euler rhs over n_t blocks: tau v_d with a zero
        final row, and tau f with the initial state's row
        tau D(v_0) v_0 + M v_0; inhomogeneous bcs lifted row by row (row 0
        through the initial-state operator, reference
        control/control.py:3011-3026)."""
        n_t, tau = self._n_t, self._tau
        if v_d is not None:
            b_0 = v_d.data
        else:
            b_0 = tau * self.construct_v_d().data
            b_0[n_t - 1] = 0.0
            if inhom:
                for i in range(n_t - 1):
                    b_0[i] += -tau * M.apply(lift(i))
            b_0 = zero_rows(mk, b_0)
        if f is not None:
            b_1 = f.data
        else:
            b_1 = tau * self.construct_f().data
            D0 = self.construct_D_v(v_0, self._time_interval[0])
            b_1[0] = tau * D0.apply(v_0.data) + M.apply(v_0.data)
            if inhom:
                li0 = lift(0)
                b_1[0] += -(tau * D0.apply(li0) + M.apply(li0))
                for i in range(1, n_t):
                    li = lift(i)
                    b_1[i] += -(tau * D_op(i).apply(li) + M.apply(li))
                    b_1[i] += M.apply(lift(i - 1))
            b_1 = zero_rows(mk, b_1)
        return b_0, b_1

    # ------------------------------------------------------------ linear solve
    def _pc_key(self, Multigrid, lambda_v_bounds, mask, Dv_A):
        return (self._n_t, self._CN, self._beta, self._time_interval,
                Multigrid,
                None if lambda_v_bounds is None else tuple(lambda_v_bounds),
                tensor_token(mask), getattr(self, "_schur_mode", "scan"),
                getattr(self, "_paradiag_alpha", None),
                getattr(self, "_paradiag_dc", 1),
                getattr(self, "_paradiag_cycles", 2),
                getattr(self, "_mg_smooth", None),
                getattr(self, "_mg_weight_dtype", None),
                getattr(self, "_mass_cheb_steps", None),
                getattr(self, "_schur_jacobi_steps", None),
                getattr(self, "_be_epsilon", 1.0e-3),
                id(self._space_v), tensor_token(Dv_A))

    def linear_solve(self, *, P=None, solver_parameters=None,
                     Multigrid=False, lambda_v_bounds=None, v_d=None,
                     f=None, print_error=True, create_output=False,
                     plots=False):
        """All-at-once KKT solve, Crank-Nicolson or (``CN=False``) backward
        Euler (reference control/control.py:2820-3375).

        The pc state (hierarchies, stencils, coarse inverses) is built once
        per linearisation and reused by repeat solves.  Runs under
        ``config.full_precision()``: no TF32 in the float32 products and
        convolutions on the card.  ``create_output=True`` writes
        ``v.npz``/``zeta.npz`` in the working directory.  A user
        preconditioner ``P`` under backward Euler is not ported (raises
        ``NotImplementedError``)."""
        if not self._CN and P is not None:
            raise NotImplementedError(
                "user preconditioners for backward Euler are not ported yet")
        if plots:
            raise NotImplementedError("plots are not ported yet")
        solver_parameters = strip_refinement(solver_parameters)
        with full_precision():
            info = self._linear_solve(P, solver_parameters, Multigrid,
                                      lambda_v_bounds, v_d, f, print_error)
        if print_error:
            self.print_error(self._tau)
        if create_output:
            times = self._times()
            for name, fn in (("v", self._v), ("zeta", self._zeta)):
                np.savez(f"{name}.npz", data=fn.data.cpu().numpy(),
                         times=times)
        return info

    def _linear_solve(self, P, solver_parameters, Multigrid,
                      lambda_v_bounds, v_d, f, print_error):
        space_v = self._space_v
        n_t = self._n_t
        inhom = any(not bc.is_homogeneous
                    for i in self._bcs_v for bc in self._bcs_v[i])
        bcs_v = (homogenize(self._bcs_v[1]) if inhom
                 else self._bcs_v[1])
        mask = combine_masks(space_v, bcs_v) if bcs_v else None
        nullspace = (DirichletBCNullspace(bcs_v) if bcs_v
                     else NoneNullspace())
        n_blocks = n_t - 1 if self._CN else n_t
        full_ns = tuple(nullspace for _ in range(n_blocks))
        epsilon = None if self._CN else getattr(self, "_be_epsilon", 1.0e-3)

        v_0 = self._initial_state()
        Dv_A = self._D_stack(self._v.data)
        M = assemble(self._M_v)
        internal_rhs = v_d is None and f is None
        b_0, b_1 = self._build_rhs(v_d, f, v_0, Dv_A, M, mask, inhom,
                                   self._bcs_v)

        if solver_parameters is None:
            solver_parameters = {"linear_solver": "gmres",
                                 "gmres_restart": 10,
                                 "maximum_iterations": 50,
                                 "relative_tolerance": 1.0e-6,
                                 "absolute_tolerance": 0.0,
                                 "monitor_convergence": print_error}

        if P is None:
            # pc state cached per linearisation (plain dict, a few entries)
            tok = self._pc_key(Multigrid, lambda_v_bounds, mask, Dv_A)
            pc_state = self._pc_state_cache.get(tok)
            if pc_state is None:
                if len(self._pc_state_cache) > 4:
                    self._pc_state_cache.clear()
                pc_state = self.construct_pc(Multigrid, lambda_v_bounds,
                                             mask, Dv_A, M,
                                             epsilon=epsilon).state
                self._pc_state_cache[tok] = pc_state
            pc_fn = self.construct_pc(Multigrid, lambda_v_bounds, mask,
                                      Dv_A, M, epsilon=epsilon,
                                      prebuilt=pc_state)
        else:
            pc_fn = P
        b00, b01, b10, b11, _ = self._blocks(Dv_A, M=M)
        system = MultiBlockSystem(
            space_v, space_v,
            block_00=b00, block_01=b01, block_10=b10, block_11=b11,
            n_blocks_00=n_blocks, n_blocks_11=n_blocks,
            nullspace_0=full_ns, nullspace_1=full_ns, CN=self._CN)
        # backward Euler: the Krylov iteration runs on the similarity-
        # transformed system whose final state block is scaled by eps.
        # The pc amplifies that block by 1/eps, which in float32 would put
        # every other component of the Krylov vectors below the rounding
        # floor; the preconditioned spectrum is unchanged.
        uscale = None
        if not self._CN:
            s0 = torch.ones(n_blocks, dtype=b_0.dtype, device=b_0.device)
            s0[n_blocks - 1] = 1.0 / epsilon
            uscale = (s0, None)
        solve = system.solve_fn(solver_parameters=dict(solver_parameters),
                                pc_fn=pc_fn, unknown_scale=uscale)
        u0, u1, info_d = solve(torch.zeros_like(b_0), torch.zeros_like(b_1),
                               b_0, b_1)
        info = finalize_solve_info(info_d, solver_parameters)
        self.last_solve_info = info

        if not self._CN:
            self.set_v(MixedFunction(space_v, n_t, data=u0, name="v"))
            self.set_zeta(MixedFunction(space_v, n_t, data=u1, name="zeta"))
            return info
        v_new = MixedFunction(space_v, n_t, name="v_new")
        zeta_new = MixedFunction(space_v, n_t, name="zeta_new")
        if internal_rhs:
            v_new.sub(0).assign(v_0)
        v_new.data[1:] = u0
        zeta_new.data[:-1] = u1
        self.set_v(v_new)
        self.set_zeta(zeta_new)
        return info

    # =====================================================================
    # incompressible (Stokes) variant
    # =====================================================================
    def _D_p_stack(self, v_old_data):
        """Pressure-space analogue of the forward operator, for the Schur
        approximation (reference control/control.py:3786-3789): the form
        assembled on pressure trial and test functions (Picard)."""
        if self._Gauss_Newton:
            raise NotImplementedError(
                "the Gauss-Newton linearisation is not ported yet")
        sp_p = self._space_p
        p_trial, p_test = TrialFunction(sp_p), TestFunction(sp_p)
        t_0, T_f = self._time_interval
        dep_v, dep_t = _probe_form_dependence(
            self._forward_form, sp_p, self._space_v,
            (t_0, t_0 + 0.618 * (T_f - t_0)))

        def one(vdata, t):
            vf = Function(self._space_v, data=vdata)
            return assemble(self._forward_form(p_trial, p_test, vf,
                                               Constant(t))).A

        if not dep_v and not dep_t:
            return one(torch.zeros_like(v_old_data[0]), float(t_0))[None]
        mats = [one(v_old_data[i], float(t))
                for i, t in enumerate(self._times())]
        E = max(a.shape[0] for a in mats)
        return torch.stack([a.expand((E,) + tuple(a.shape[1:]))
                            for a in mats])

    def _incompressible_blocks(self, Dv_A, B, B_T, M=None):
        """The 2n x 2n velocity-KKT and divergence block dicts of the
        Crank-Nicolson system (reference control/control.py:3750-3957):
        rows and columns 0..n-1 belong to v, n..2n-1 to zeta."""
        if not self._CN:
            raise NotImplementedError("backward Euler is not ported yet")
        tau = self._tau
        n = self._n_t - 1
        i00, i01, i10, i11, M = self._blocks(Dv_A, M=M)
        block_00 = dict(i00)
        block_00.update({(i, n + j): o for (i, j), o in i01.items()})
        block_00.update({(n + i, j): o for (i, j), o in i10.items()})
        block_00.update({(n + i, n + j): o for (i, j), o in i11.items()})
        tB = LocalOp(tau * B.A, B.trial_space, B.test_space)
        tBT = LocalOp(tau * B_T.A, B_T.trial_space, B_T.test_space)
        block_01 = {(i, i): tBT for i in range(2 * n)}
        block_10 = {(i, i): tB for i in range(2 * n)}
        return block_00, block_01, block_10, {}, M

    def _p_kkt_dicts(self, Dp_A):
        """Pressure-space space-time KKT dicts for the Schur approximation
        (reference control/control.py:3722-3957), Crank-Nicolson: the
        blocks of ``_blocks`` built from the pressure-space operator and
        mass."""
        return self._blocks(Dp_A, M=assemble(self._M_p),
                            space=self._space_p)

    def incompressible_linear_solve(self, nullspace_p, *, space_p=None,
                                    P=None, solver_parameters=None,
                                    Multigrid=False, lambda_v_bounds=None,
                                    lambda_p_bounds=None, v_d=None, f=None,
                                    div_v=None, div_zeta=None,
                                    print_error=True, create_output=False,
                                    plots=False, _return_pieces=False):
        """Space-time Stokes KKT solve with the nested preconditioner
        (reference control/control.py:3592-4884), Crank-Nicolson: five
        fixed inner GMRES iterations on the full space-time velocity KKT
        system plus a per-time-block pressure Schur part
        K_p^{-1} (KKT_p) M_p^{-1} with 1/tau^2 scaling and T sandwiches.

        The unknowns are 2n velocity blocks (v_1..v_n, zeta_0..zeta_{n-1})
        and 2n pressure blocks (mu, p), n = n_t - 1.  ``v_d``, ``f``,
        ``div_v`` and ``div_zeta`` replace the four right-hand sides by
        given stacks.  The Krylov loop runs on the host with every vector
        on the device, as in ``linear_solve``.

        ``_return_pieces``: skip the solve and return
        ``(system, pc_fn, b_0, b_1)``.

        Not ported (each raises ``NotImplementedError``): backward Euler,
        a user preconditioner ``P``, iterative refinement, the
        divergence-free projection of the initial state, inhomogeneous
        velocity data, the ParaDiag and jacobi sweeps on vector spaces,
        plots."""
        if not self._CN:
            raise NotImplementedError("backward Euler is not ported yet")
        if P is not None:
            raise NotImplementedError(
                "user preconditioners for the incompressible solve are "
                "not ported yet")
        if plots:
            raise NotImplementedError("plots are not ported yet")
        solver_parameters = strip_refinement(solver_parameters)
        if getattr(self, "_divfree_initial", False):
            raise NotImplementedError(
                "the divergence-free projection of the initial state is "
                "not ported yet")
        if space_p is not None:
            self.set_space_p(space_p)
        elif self._space_p is None:
            raise ValueError("Undefined space_p")
        if any(not bc.is_homogeneous
               for i in self._bcs_v for bc in self._bcs_v[i]):
            raise NotImplementedError(
                "inhomogeneous velocity data is not ported yet for the "
                "incompressible solve")
        with full_precision():
            out = self._incompressible_linear_solve(
                nullspace_p, solver_parameters, Multigrid, lambda_v_bounds,
                lambda_p_bounds, v_d, f, div_v, div_zeta, print_error,
                _return_pieces)
        if _return_pieces:
            return out
        if print_error:
            self.print_error(self._tau)
        if create_output:
            times = self._times()
            for name, fn, ts in (("v", self._v, times),
                                 ("zeta", self._zeta, times),
                                 ("p", self._p, times[:self._n_t - 1]),
                                 ("mu", self._mu, times[:self._n_t - 1])):
                np.savez(f"{name}.npz", data=fn.data.cpu().numpy(),
                         times=ts)
        return out

    def _incompressible_linear_solve(self, nullspace_p, solver_parameters,
                                     Multigrid, lambda_v_bounds,
                                     lambda_p_bounds, v_d, f, div_v,
                                     div_zeta, print_error, return_pieces):
        space_v, space_p = self._space_v, self._space_p
        n_t, tau = self._n_t, self._tau
        n = n_t - 1
        bcs_v = self._bcs_v[1]
        mask = combine_masks(space_v, bcs_v) if bcs_v else None
        nullspace_v = (DirichletBCNullspace(bcs_v) if bcs_v
                       else NoneNullspace())
        full_ns_0 = tuple(nullspace_v for _ in range(2 * n))
        full_ns_1 = tuple(nullspace_p for _ in range(2 * n))

        v_0 = self._initial_state()
        Dv_A = self._D_stack(self._v.data)
        v_trial, v_test = TrialFunction(space_v), TestFunction(space_v)
        p_trial, p_test = TrialFunction(space_p), TestFunction(space_p)
        B = assemble(-inner(div(v_trial), p_test) * dx)
        B_T = assemble(-inner(p_trial, div(v_test)) * dx)
        M = assemble(self._M_v)

        # rhs: the velocity part is the heat problem's
        b_0_0, b_0_1 = self._build_rhs(v_d, f, v_0, Dv_A, M, mask, False,
                                       self._bcs_v)

        def stack_of(given):
            if given is None:
                return space_p.zeros(n)
            return given.data if hasattr(given, "data") else given

        b_0 = torch.cat([b_0_0, b_0_1])
        b_1 = torch.cat([apply_T_2(stack_of(div_v)),
                         apply_T_1(stack_of(div_zeta))])

        if solver_parameters is None:
            solver_parameters = {"linear_solver": "fgmres",
                                 "fgmres_restart": 10,
                                 "maximum_iterations": 100,
                                 "relative_tolerance": 1.0e-6,
                                 "absolute_tolerance": 0.0,
                                 "monitor_convergence": print_error}
        Dp_A = self._D_p_stack(self._v.data)

        def make_pieces(pc_state=None):
            b00, b01, b10, b11, _ = self._incompressible_blocks(
                Dv_A, B, B_T, M=M)
            system = MultiBlockSystem(
                space_v, space_p,
                block_00=b00, block_01=b01, block_10=b10, block_11=b11,
                n_blocks_00=2 * n, n_blocks_11=2 * n,
                sub_n_blocks_00_0=n, sub_n_blocks_11_0=n,
                nullspace_0=full_ns_0, nullspace_1=full_ns_1, CN=True)

            # inner velocity-KKT system (the heat problem's blocks)
            i00, i01, i10, i11, _ = self._blocks(Dv_A, M=M)
            inner_ns = tuple(nullspace_v for _ in range(n))
            inner_system = MultiBlockSystem(
                space_v, space_v,
                block_00=i00, block_01=i01, block_10=i10, block_11=i11,
                n_blocks_00=n, n_blocks_11=n,
                nullspace_0=inner_ns, nullspace_1=inner_ns, CN=True)
            inner_pc = self.construct_pc(
                Multigrid, lambda_v_bounds, mask, Dv_A, M,
                prebuilt=None if pc_state is None else pc_state["inner"])
            # the reference fixes 5 inner iterations
            # (control/control.py:4355-4361)
            inner_solve = inner_system.solve_fn(
                solver_parameters={"preconditioner": True,
                                   "linear_solver": "gmres",
                                   "maximum_iterations": 5,
                                   "relative_tolerance": 0.0,
                                   "absolute_tolerance": 0.0,
                                   "gmres_restart": 30},
                pc_fn=inner_pc)

            p00, p01, p10, p11, M_p = self._p_kkt_dicts(Dp_A)
            K_p = regularized_stiffness(
                assemble(inner(grad(p_trial), grad(p_test)) * dx), M_p)
            solver_K_p = BlockSolver(K_p, None, ("mg", 1),
                                     state=None if pc_state is None
                                     else pc_state["K_p"])
            solver_M_p = mass_solver(M_p, None, False, lambda_p_bounds,
                                     state=None if pc_state is None
                                     else pc_state["M_p"],
                                     steps=getattr(self, "_mass_cheb_steps",
                                                   None))
            act_00 = BlockAction(p00, n, n, space_p, space_p)
            act_01 = BlockAction(p01, n, n, space_p, space_p)
            act_10 = BlockAction(p10, n, n, space_p, space_p)
            act_11 = BlockAction(p11, n, n, space_p, space_p)

            def pc_fn(b_0, b_1):
                z = torch.zeros_like(b_0[:n])
                u0v, u0z, _ = inner_solve(z, z, b_0[:n], b_0[n:])
                u_0 = torch.cat([u0v, u0z])
                # pressure Schur: 1/tau^2 scaling and T sandwiches
                b0h = apply_T_2(tau * B.apply(u0v))
                b1h = apply_T_1(tau * B.apply(u0z))
                b0h = apply_T_2_inv((b0h - b_1[:n]) / tau ** 2)
                b1h = apply_T_1_inv((b1h - b_1[n:]) / tau ** 2)
                # K_p and M_p are time-independent: the (mu, p) pair and
                # all time blocks solve as one batch of 2n blocks
                u1k = solver_K_p(torch.cat([b0h, b1h]))
                u10, u11 = u1k[:n], u1k[n:]
                c0 = act_00.apply(u10) + act_01.apply(u11)
                c1 = act_10.apply(u10) + act_11.apply(u11)
                u1m = solver_M_p(torch.cat([c0, c1]))
                return u_0, u1m

            pc_fn.state = {"inner": inner_pc.state,
                           "K_p": solver_K_p.state,
                           "M_p": solver_M_p.state}
            return system, pc_fn

        if return_pieces:
            system, pc_fn = make_pieces()
            return system, pc_fn, b_0, b_1

        # pc state cached per linearisation, as in linear_solve
        tok = (self._pc_key(Multigrid, lambda_v_bounds, mask, Dv_A),
               "incompressible",
               None if lambda_p_bounds is None else tuple(lambda_p_bounds),
               tuple(Dp_A.shape), Dp_A.detach().cpu().numpy().tobytes(),
               id(space_p))
        pc_state = self._pc_state_cache.get(tok)
        if pc_state is None:
            if len(self._pc_state_cache) > 4:
                self._pc_state_cache.clear()
            pc_state = make_pieces()[1].state
            self._pc_state_cache[tok] = pc_state
        system, pc_fn = make_pieces(pc_state=pc_state)
        solve = system.solve_fn(solver_parameters=dict(solver_parameters),
                                pc_fn=pc_fn)
        u0, u1, info_d = solve(torch.zeros_like(b_0), torch.zeros_like(b_1),
                               b_0, b_1)
        info = finalize_solve_info(info_d, solver_parameters)
        self.last_solve_info = info

        v = MixedFunction(space_v, n_t, name="v")
        zeta = MixedFunction(space_v, n_t, name="zeta")
        if v_d is None and f is None:
            v.sub(0).assign(v_0)
        v.data[1:] = u0[:n]
        zeta.data[:-1] = u0[n:]
        self.set_v(v)
        self.set_zeta(zeta)
        self.set_p(MixedFunction(space_p, n, data=u1[n:], name="p"))
        self.set_mu(MixedFunction(space_p, n, data=u1[:n], name="mu"))
        return info

    def incompressible_non_linear_solve(self, *args, **kwargs):
        raise NotImplementedError(
            "the nonlinear incompressible (Navier-Stokes) solve is not "
            "ported yet")
