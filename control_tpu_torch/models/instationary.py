"""Instationary (space-time all-at-once) optimal control problems, the
Crank-Nicolson linear path.

The all-at-once vector over n_t time steps is a stacked tensor
(n_t, *grid); the block-bidiagonal space-time KKT operator becomes a
handful of batched contractions (one per block diagonal), and the
Crank-Nicolson T1/T2 symmetrisation is a pair of (alternating-)cumsums.

The built-in preconditioner reproduces the reference's recipe
(control/control.py:1943-2440): block-(1,1) mass solves vectorised over all
time blocks at once (kernel K2), and a matching-Schur approximation

    S ~ (L + c M) M^{-1} (L^T + c M),   c = 0.5 tau / sqrt(beta)

whose forward/backward block substitutions run either exactly, one time
block after another with one multigrid V-cycle each ("scan", the default),
or all at once by ParaDiag: an alpha-circulant approximation diagonalised
by a time-axis DFT, with one batched complex V-cycle over the frequencies
(kernel K3) and a defect correction (kernel K1).
"""

import numpy as np
import torch

from ..config import complex_dtype, full_precision
from ..fem.expr import TrialFunction, TestFunction, Constant, inner
from ..fem.forms import dx
from ..fem.space import (Function, MixedFunction, DirichletBC, homogenize,
                         combine_masks)
from ..fem.assemble import assemble
from ..ops.local_op import LocalOp
from ..ops.stencil import node_stencil, apply_stencil
from ..solvers.block import (MultiBlockSystem, DirichletBCNullspace,
                             NoneNullspace, apply_T_1, apply_T_2,
                             apply_T_1_inv, apply_T_2_inv,
                             finalize_solve_info)
from ..solvers.multigrid import MGConfig, index_params, flip_params
from .common import mass_solver, zero_rows, bc_lift_function


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
    (kernel K1 on the card)."""
    w = node_stencil(A, space)
    d, nd = space.degree, space.ndim
    return lambda x: apply_stencil(w, x, d, nd=nd)


class _SweepSolver:
    """Sequential solve of a block lower-bidiagonal system
    u_i = V-cycle_i(b_i - S_i u_{i-1}), one time block after another, with
    per-time-block multigrid hierarchies built once (batched when the
    blocks differ).  The sub-diagonal action is a node stencil (K1), the
    V-cycle smoothing real (K2)."""

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
            self.sub = node_stencil(sub_A, space)      # (m|1, K, ny, nx)
        self.state = {"params": self.params, "sub": self.sub}

    def solve(self, b, reverse=False):
        n = b.shape[0]
        params, sub = self.params, self.sub
        if reverse:
            b = torch.flip(b, (0,))
            if not self.shared:
                params = flip_params(params)
            if sub.shape[0] > 1:
                sub = torch.flip(sub, (0,))
        deg, nd = self.space.degree, self.space.ndim
        u_prev = None
        out = []
        for i in range(n):
            rhs = b[i]
            if i > 0:
                # row i couples to u_{i-1} through S_i (shared, or the
                # (i-1)-th entry of the per-row stack)
                S_i = sub[0] if sub.shape[0] == 1 else sub[i - 1]
                rhs = rhs - apply_stencil(S_i, u_prev, deg, nd=nd)
            rhs = zero_rows(self.mask, rhs)
            p_i = params if self.shared else index_params(params, i)
            u_prev = self.config.apply(p_i, rhs, cycles=self.cycles)
            out.append(u_prev)
        u = torch.stack(out)
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
    application."""

    def __init__(self, space, mask, diag_A, sub_A, n, alpha=None,
                 cycles=2, state=None, defect_steps=1, smooth=None,
                 weight_dtype=None):
        if diag_A.shape[0] != 1 or n < 2:
            raise ValueError("ParaDiag requires a Toeplitz (time-"
                             "independent) sweep factor over n >= 2 rows")
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
        cdtype = complex_dtype(rdtype)
        dev = diag_A.device
        n_f = n // 2 + 1
        if state is None:
            k = np.arange(n_f)
            mu = torch.as_tensor(
                self.alpha ** (1.0 / n) * np.exp((-2j * np.pi / n) * k),
                dtype=cdtype, device=dev)
            F = diag_A[0].to(cdtype)
            S = sub_A[0].expand(diag_A.shape[1:]).to(cdtype)
            A_k = F[None] + mu[:, None, None, None] * S[None]
            self.params = self.config.build(A_k)
            # exact bidiagonal factor stencils for the defect correction
            # (masked rows: identity on the diagonal factor, zero on the
            # sub-diagonal)
            self._wF = node_stencil(diag_A[0], space, mask=mask)
            self._wS = node_stencil(sub_A[0].expand(diag_A.shape[1:]),
                                    space, mask=mask, alpha=0.0)
        else:
            self.params = state["params"]
            self._wF = state["wF"]
            self._wS = state["wS"]
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
        if reverse:
            b = torch.flip(b, (0,))
        b = zero_rows(mk, b)
        u = self._circulant_solve(b)
        for _ in range(self.defect_steps):
            r = b - self._factor_apply(u)
            u = u + self._circulant_solve(r)
        u = zero_rows(mk, u)
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
        if space_p is not None:
            raise NotImplementedError(
                "the incompressible problems are not ported yet")
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

    def set_v(self, v_new):
        self._v.assign(v_new)
        mk, val = self._bc_stack()
        self._v.data = torch.where(mk, val, self._v.data)

    def set_zeta(self, zeta_new):
        self._zeta.assign(zeta_new)
        bcs_zeta = homogenize(self._bcs_v[1])
        if bcs_zeta:
            mask = combine_masks(self._space_v, bcs_zeta)
            self._zeta.data = torch.where(mask[None], 0.0, self._zeta.data)

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
    def _blocks(self, Dv_A, M=None):
        """Block dicts of the Crank-Nicolson all-at-once KKT operator
        (reference control/control.py:2889-2978)."""
        if not self._CN:
            raise NotImplementedError("backward Euler is not ported yet")
        n_t, tau, beta = self._n_t, self._tau, self._beta
        sp = self._space_v
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
    def _make_sweeps(self, space, mask, F_diag, F_sub, G_diag, G_sup, n,
                     prebuilt=None):
        """Build the forward/backward Schur substitution solvers for the
        selected mode.  ParaDiag applies when both factors are Toeplitz (a
        time-independent operator: one diagonal factor for all rows);
        otherwise the exact sequential sweep runs, whatever the mode."""
        mode = getattr(self, "_schur_mode", "scan")
        toeplitz = F_diag.shape[0] == 1 and G_diag.shape[0] == 1
        if mode in ("auto", "paradiag") and n > 1 and toeplitz:
            kw = dict(alpha=getattr(self, "_paradiag_alpha", None),
                      defect_steps=getattr(self, "_paradiag_dc", 1),
                      cycles=getattr(self, "_paradiag_cycles", 2),
                      smooth=getattr(self, "_mg_smooth", None),
                      weight_dtype=getattr(self, "_mg_weight_dtype", None))
            fwd = _ParaDiagSweep(space, mask, F_diag, F_sub, n,
                                 state=None if prebuilt is None
                                 else prebuilt["fwd"], **kw)
            bwd = _ParaDiagSweep(space, mask, G_diag, G_sup, n,
                                 state=None if prebuilt is None
                                 else prebuilt["bwd"], **kw)
            return fwd, bwd
        fwd = _SweepSolver(space, mask, F_diag, F_sub,
                           state=None if prebuilt is None
                           else prebuilt["fwd"])
        bwd = _SweepSolver(space, mask, G_diag, G_sup,
                           state=None if prebuilt is None
                           else prebuilt["bwd"])
        return fwd, bwd

    def set_schur_sweep(self, mode, steps=None, paradiag_alpha=None,
                        paradiag_defect_steps=None, paradiag_cycles=None,
                        smooth=None, weight_dtype=None):
        """Select the Schur substitution strategy ("scan" | "paradiag" |
        "auto"), optionally fixing the ParaDiag circulant parameter alpha,
        the number of ParaDiag defect-correction steps (default 1), the
        V-cycle count of the per-frequency solves (default 2), the
        (pre, post) Chebyshev smoothing step counts of the ParaDiag
        frequency V-cycles (default (8, 8)), or the storage dtype of the
        smoothers' weight planes (e.g. "bfloat16", plain version only).
        ``steps`` belongs to the jacobi sweep, which is not ported."""
        if mode == "jacobi" or steps is not None:
            raise NotImplementedError(
                "the jacobi Schur sweep is not ported yet")
        if mode not in ("scan", "paradiag", "auto"):
            raise ValueError(f"unknown Schur sweep {mode!r}")
        self._schur_mode = mode
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
                     prebuilt=None):
        """The reference's CN block preconditioner
        (control/control.py:1943-2440), with the (1,1) mass solves batched
        over all time blocks.

        The returned callable carries a ``.state`` dict of every tensor it
        derived (multigrid hierarchies, stencils, coarse inverses).  Passing
        that dict back via ``prebuilt=`` rebuilds an identical pc without
        re-deriving the state."""
        if not self._CN:
            raise NotImplementedError("backward Euler is not ported yet")
        n_t, tau, beta = self._n_t, self._tau, self._beta
        sp = self._space_v
        M_A = M.A
        solver_0 = mass_solver(M, mask, Multigrid, lambda_v_bounds,
                               state=None if prebuilt is None
                               else prebuilt["solver_0"],
                               steps=getattr(self, "_mass_cheb_steps",
                                             None))
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
        fwd, bwd = self._make_sweeps(sp, mask, F_diag, F_sub, G_diag, G_sup,
                                     n, prebuilt=prebuilt)
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
            u_1 = fwd.solve(b, reverse=False)
            u_1 = apply_T_2(u_1)
            # multiply 0.5 tau M
            b = 0.5 * tau * ap_M(u_1)
            b = zero_rows(mk, b)
            # backward substitution (L^T + cM)
            u_1 = bwd.solve(b, reverse=True)
            return u_0, u_1

        pc_linear.state = {"solver_0": solver_0.state,
                           "fwd": fwd.state, "bwd": bwd.state}
        return pc_linear

    # ------------------------------------------------------------ rhs build
    def _build_rhs(self, v_d, f, v_0, Dv_A, M, mask, inhom, bcs_v_help):
        """All-at-once Crank-Nicolson rhs incl. initial-condition and
        inhomogeneous-bc lifts (reference control/control.py:2980-3243).
        Returns stacked (b_0, b_1).  The T1/T2 symmetrisation is applied
        unconditionally, also to caller-supplied rhs (reference
        control/control.py:3242-3243)."""
        n_t, tau = self._n_t, self._tau
        sp = self._space_v
        sh = Dv_A.shape[0] == 1

        def D_op(i):
            return LocalOp(Dv_A[0] if sh else Dv_A[i], sp, sp)

        def lift(i):
            return bc_lift_function(sp, bcs_v_help[i]).data

        mk = mask[None] if mask is not None else None
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

    # ------------------------------------------------------------ linear solve
    def _pc_key(self, Multigrid, lambda_v_bounds, mask, Dv_A):
        def tok(t):
            if t is None:
                return None
            return (tuple(t.shape), str(t.dtype),
                    t.detach().cpu().numpy().tobytes())
        return (self._n_t, self._CN, self._beta, self._time_interval,
                Multigrid,
                None if lambda_v_bounds is None else tuple(lambda_v_bounds),
                tok(mask), getattr(self, "_schur_mode", "scan"),
                getattr(self, "_paradiag_alpha", None),
                getattr(self, "_paradiag_dc", 1),
                getattr(self, "_paradiag_cycles", 2),
                getattr(self, "_mg_smooth", None),
                getattr(self, "_mg_weight_dtype", None),
                getattr(self, "_mass_cheb_steps", None),
                id(self._space_v), tok(Dv_A))

    def linear_solve(self, *, P=None, solver_parameters=None,
                     Multigrid=False, lambda_v_bounds=None, v_d=None,
                     f=None, print_error=True, create_output=False,
                     plots=False):
        """All-at-once Crank-Nicolson KKT solve (reference
        control/control.py:2820-3375).

        The pc state (hierarchies, stencils, coarse inverses) is built once
        per linearisation and reused by repeat solves.  Runs under
        ``config.full_precision()``: no TF32 in the float32 products and
        convolutions on the card.  ``create_output=True`` writes
        ``v.npz``/``zeta.npz`` in the working directory."""
        if not self._CN:
            raise NotImplementedError("backward Euler is not ported yet")
        if plots:
            raise NotImplementedError("plots are not ported yet")
        if solver_parameters is not None and (
                "iterative_refinement" in solver_parameters
                or "refinement_inner_tolerance" in solver_parameters):
            raise NotImplementedError(
                "iterative refinement is not ported yet")
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
        n_blocks = n_t - 1
        full_ns = tuple(nullspace for _ in range(n_blocks))

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
                                             mask, Dv_A, M).state
                self._pc_state_cache[tok] = pc_state
            pc_fn = self.construct_pc(Multigrid, lambda_v_bounds, mask,
                                      Dv_A, M, prebuilt=pc_state)
        else:
            pc_fn = P
        b00, b01, b10, b11, _ = self._blocks(Dv_A, M=M)
        system = MultiBlockSystem(
            space_v, space_v,
            block_00=b00, block_01=b01, block_10=b10, block_11=b11,
            n_blocks_00=n_blocks, n_blocks_11=n_blocks,
            nullspace_0=full_ns, nullspace_1=full_ns, CN=True)
        solve = system.solve_fn(solver_parameters=dict(solver_parameters),
                                pc_fn=pc_fn)
        u0, u1, info_d = solve(torch.zeros_like(b_0), torch.zeros_like(b_1),
                               b_0, b_1)
        info = finalize_solve_info(info_d, solver_parameters)
        self.last_solve_info = info

        v_new = MixedFunction(space_v, n_t, name="v_new")
        zeta_new = MixedFunction(space_v, n_t, name="zeta_new")
        if internal_rhs:
            v_new.sub(0).assign(v_0)
        v_new.data[1:] = u0
        zeta_new.data[:-1] = u1
        self.set_v(v_new)
        self.set_zeta(zeta_new)
        return info
