"""Form lowering: expressions -> batched element tensors -> LocalOp /
Cofunction / scalar.

Forms are evaluated at quadrature points as broadcast tensors with axis
convention

    (E, Q, A, B, *value_shape)

E = cells, Q = quadrature points, A = trial basis, B = test basis (axes of
size 1 when absent).  Constant-coefficient forms keep E = 1, so operator
application becomes a single batched matmul.

Spatial-only subtrees (manufactured solutions) are differentiated with
``torch.func`` autodiff instead of UFL symbolic calculus.
"""

import numpy as np
import torch
from torch.func import vmap, jacfwd

from . import elements
from . import expr as X
from .forms import Form, dx
from .space import Function, Cofunction, _SubView, DirichletBC, combine_masks
from ..ops.local_op import LocalOp, MaskedOp


# ---------------------------------------------------------------------------
# helpers: spatial-only point functions (autodiff replaces UFL calculus)
# ---------------------------------------------------------------------------

def _const(value, like):
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def make_point_fn(e):
    """Build f(x, y[, z]) -> value (0-d or 1-d tensor) for a spatial-only
    expression (variadic in the mesh dimension)."""
    if isinstance(e, (X.ScalarLiteral, X.Constant)):
        return lambda *c: _const(e.value, c[0])
    if isinstance(e, X.SpatialX):
        i = e.i
        return lambda *c: c[i]
    if isinstance(e, X.SpatialCoordinate):
        return lambda *c: torch.stack(c)
    if isinstance(e, X.Sum):
        fa, fb = make_point_fn(e.a), make_point_fn(e.b)
        return lambda *c: fa(*c) + fb(*c)
    if isinstance(e, X.Product):
        fa, fb = make_point_fn(e.a), make_point_fn(e.b)
        return lambda *c: fa(*c) * fb(*c)
    if isinstance(e, X.Pow):
        fa = make_point_fn(e.a)
        p = e.p
        return lambda *c: fa(*c) ** p
    if isinstance(e, X.Indexed):
        fa = make_point_fn(e.a)
        i = e.i
        return lambda *c: fa(*c)[i]
    if isinstance(e, X.AsVector):
        fs = [make_point_fn(comp) for comp in e.comps]
        return lambda *c: torch.stack([f(*c) for f in fs])
    if isinstance(e, X.Grad):
        fa = make_point_fn(e.a)

        def gfn(*c):
            def packed(v):
                return fa(*tuple(v))
            return jacfwd(packed)(torch.stack(c))

        return gfn
    if isinstance(e, X.Div):
        fa = make_point_fn(e.a)

        def dfn(*c):
            def packed(v):
                return fa(*tuple(v))
            J = jacfwd(packed)(torch.stack(c))
            return torch.trace(J)

        return dfn
    if isinstance(e, X.Dot):
        fa, fb = make_point_fn(e.a), make_point_fn(e.b)
        return lambda *c: torch.tensordot(fa(*c), fb(*c), dims=1)
    if isinstance(e, X.Inner):
        fa, fb = make_point_fn(e.a), make_point_fn(e.b)
        return lambda *c: torch.sum(fa(*c) * fb(*c))
    if isinstance(e, X.MathFn):
        fa = make_point_fn(e.a)
        fn = _MATH_FNS[e.fn_name]
        return lambda *c: fn(fa(*c))
    if isinstance(e, X.Conditional):
        fc_a, fc_b = make_point_fn(e.cond.a), make_point_fn(e.cond.b)
        ft, ff = make_point_fn(e.t), make_point_fn(e.f)
        op = _CMP_FNS[e.cond.op]
        return lambda *c: torch.where(op(fc_a(*c), fc_b(*c)),
                                      ft(*c), ff(*c))
    raise NotImplementedError(
        f"spatial point function for {type(e).__name__}")


_MATH_FNS = {"sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
             "exp": torch.exp, "sqrt": torch.sqrt, "tanh": torch.tanh,
             "abs": torch.abs}
_CMP_FNS = {"ge": lambda a, b: a >= b, "le": lambda a, b: a <= b,
            "gt": lambda a, b: a > b, "lt": lambda a, b: a < b}


def _eval_spatial(e, *coords):
    """Evaluate a spatial-only expression at points; coordinate tensors
    (x, y[, z]) of any common shape; result shape coords[0].shape + e.shape."""
    f = make_point_fn(e)
    flats = tuple(torch.ravel(c) for c in coords)
    vals = vmap(f)(*flats)
    return vals.reshape(tuple(coords[0].shape) + e.shape)


# ---------------------------------------------------------------------------
# point evaluation of general expressions (for interpolate)
# ---------------------------------------------------------------------------

def _locate(mesh, pts):
    """Cells and cell-local coordinates of physical points (numpy)."""
    pts = np.asarray(pts, dtype=np.float64)
    fx = (pts[:, 0] - mesh.x0) / mesh.hx
    fy = (pts[:, 1] - mesh.y0) / mesh.hy
    ix = np.clip(np.floor(fx - 1e-12).astype(int), 0, mesh.nx - 1)
    iy = np.clip(np.floor(fy - 1e-12).astype(int), 0, mesh.ny - 1)
    if getattr(mesh, "ndim", 2) == 3:
        fz = (pts[:, 2] - mesh.z0) / mesh.hz
        iz = np.clip(np.floor(fz - 1e-12).astype(int), 0, mesh.nz - 1)
        loc = np.stack([fx - ix, fy - iy, fz - iz], axis=-1)
        loc = np.clip(loc, 0.0, 1.0)
        cell = (iz * mesh.ny + iy) * mesh.nx + ix
        return cell, loc
    loc = np.stack([fx - ix, fy - iy], axis=-1)
    loc = np.clip(loc, 0.0, 1.0)
    cell = iy * mesh.nx + ix
    return cell, loc


def _fem_eval_at_points(f, pts, deriv=False):
    """Evaluate Function ``f`` (or its gradient) at physical points."""
    sp = f.function_space()
    mesh = sp.mesh
    cell, loc = _locate(mesh, pts)
    N, dN = elements.tabulate_scalar(mesh.cell, sp.degree, loc)
    fe = sp.gather(f.data)          # (E, nloc)
    dtype, dev = f.data.dtype, f.data.device
    fe_p = fe[torch.as_tensor(cell, device=dev)]      # (npts, nloc[*dim])
    h = (np.array([mesh.hx, mesh.hy, mesh.hz]) if sp.ndim == 3
         else np.array([mesh.hx, mesh.hy]))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    if sp.dim is None:
        if not deriv:
            return torch.einsum("pa,pa->p", t(N), fe_p)
        return torch.einsum("pad,pa->pd", t(dN / h), fe_p)
    fe_p = fe_p.reshape(fe_p.shape[0], sp.nloc_scalar, sp.dim)
    if not deriv:
        return torch.einsum("pa,pac->pc", t(N), fe_p)
    return torch.einsum("pad,pac->pcd", t(dN / h), fe_p)


def eval_at_points(e, pts, dtype=None, device=None):
    """Evaluate expression ``e`` (no trial/test) at physical points
    (npts, 2) -> (npts, *e.shape).  Spatial-only expressions evaluate in
    ``dtype`` on ``device`` (default: float64 on the CPU)."""
    if e.has_trial or e.has_test:
        raise ValueError("cannot point-evaluate trial/test functions")
    if e.spatial_only:
        coords = tuple(torch.as_tensor(pts[:, i],
                                       dtype=dtype or torch.float64,
                                       device=device)
                       for i in range(pts.shape[1]))
        return _eval_spatial(e, *coords)

    def ev(a):
        return eval_at_points(a, pts, dtype, device)

    if isinstance(e, (Function, _SubView)):
        return _fem_eval_at_points(e, pts)
    if isinstance(e, X.Grad):
        a = e.a
        if isinstance(a, (Function, _SubView)):
            return _fem_eval_at_points(a, pts, deriv=True)
        if isinstance(a, X.Sum):
            return ev(X.Grad(a.a)) + ev(X.Grad(a.b))
        raise NotImplementedError("grad of nonlinear FEM expression")
    if isinstance(e, X.Div):
        a = e.a
        if isinstance(a, (Function, _SubView)):
            g = _fem_eval_at_points(a, pts, deriv=True)
            return torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
        if isinstance(a, X.Sum):
            return ev(X.Div(a.a)) + ev(X.Div(a.b))
        raise NotImplementedError("div of nonlinear FEM expression")
    if isinstance(e, X.Sum):
        return ev(e.a) + ev(e.b)
    if isinstance(e, X.Product):
        va, vb = ev(e.a), ev(e.b)
        if e.a.shape == () and e.b.shape != ():
            va = va[(...,) + (None,) * len(e.b.shape)]
        if e.b.shape == () and e.a.shape != ():
            vb = vb[(...,) + (None,) * len(e.a.shape)]
        return va * vb
    if isinstance(e, X.Pow):
        return ev(e.a) ** e.p
    if isinstance(e, X.MathFn):
        return _MATH_FNS[e.fn_name](ev(e.a))
    if isinstance(e, X.Indexed):
        return ev(e.a)[:, e.i]
    if isinstance(e, X.AsVector):
        return torch.stack([ev(c) for c in e.comps], dim=-1)
    if isinstance(e, X.Inner):
        va, vb = ev(e.a), ev(e.b)
        axes = tuple(range(1, va.dim()))
        return torch.sum(va * vb, dim=axes) if axes else va * vb
    if isinstance(e, X.Dot):
        va, vb = ev(e.a), ev(e.b)
        return torch.einsum("p...k,pk->p...", va, vb)
    if isinstance(e, X.Conditional):
        ca = ev(e.cond.a)
        cb = ev(e.cond.b)
        return torch.where(_CMP_FNS[e.cond.op](ca, cb), ev(e.t), ev(e.f))
    if isinstance(e, (X.ScalarLiteral, X.Constant)):
        v = torch.as_tensor(e.value, dtype=dtype or torch.float64,
                            device=device)
        return v.expand((pts.shape[0],) + tuple(v.shape))
    raise NotImplementedError(f"eval_at_points: {type(e).__name__}")


def interpolate(space, value):
    """Interpolate a value onto the node grid of ``space``.

    ``value``: scalar | tuple (vector spaces) | Expr | Function | callable
    of the (x, y[, z]) numpy coordinate arrays.
    """
    dtype, dev = space.mesh.dtype, space.mesh.device
    coords = space.node_coords()
    if np.isscalar(value):
        return torch.full(space.grid_shape, float(value), dtype=dtype,
                          device=dev)
    if isinstance(value, (tuple, list)):
        if space.dim is None:
            raise ValueError("tuple value on a scalar space")
        from .space import FunctionSpace
        scalar = FunctionSpace(space.mesh, degree=space.degree)
        comps = [interpolate(scalar, c) for c in value]
        return torch.stack(comps, dim=-1).to(dtype)
    if isinstance(value, (Function, _SubView)) and value.space == space:
        return value.data.to(dtype)
    if isinstance(value, X.Expr):
        pts = np.stack([c.ravel() for c in coords], axis=-1)
        vals = eval_at_points(value, pts, dtype=dtype, device=dev)
        if space.dim is None:
            if value.shape != ():
                raise ValueError("vector value on scalar space")
        elif value.shape != (space.dim,):
            raise ValueError("value shape mismatch")
        return vals.reshape(space.grid_shape).to(dtype)
    if callable(value):
        vals = value(*coords)
        return torch.as_tensor(np.asarray(vals), dtype=dtype,
                               device=dev).reshape(space.grid_shape)
    raise TypeError(f"cannot interpolate {type(value)}")


# ---------------------------------------------------------------------------
# quadrature-context evaluation
# ---------------------------------------------------------------------------

class _QCtx:
    def __init__(self, mesh, nq1d, dtype, coef_override=None):
        self.mesh = mesh
        self.ndim = getattr(mesh, "ndim", 2)
        self.dtype = dtype
        self.device = mesh.device
        pts, w = elements.cell_quadrature(mesh.cell, nq1d)
        self.qpts = pts                           # (Q,ndim) cell-ref, numpy
        # keep the 2-D product order w*hx*hy (not w*(hx*hy)), as the
        # reference does
        w_phys = w * mesh.hx * mesh.hy
        if self.ndim == 3:
            w_phys = w_phys * mesh.hz
        self._h = (np.array([mesh.hx, mesh.hy, mesh.hz]) if self.ndim == 3
                   else np.array([mesh.hx, mesh.hy]))
        self.w_phys = self.t(w_phys)
        self.Q = len(w)
        self._tab = {}
        self._coef = {}
        self._phys = None
        self.coef_override = coef_override or {}

    def t(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def tab(self, space):
        key = (space.degree, space.dim)
        if key not in self._tab:
            N, dN = elements.tabulate_scalar(self.mesh.cell, space.degree,
                                             self.qpts)
            dN = dN / self._h
            if space.dim is not None:
                d = space.dim
                nloc = N.shape[1]
                Nv = np.zeros((self.Q, nloc * d, d))
                dNv = np.zeros((self.Q, nloc * d, d, self.ndim))
                for c in range(d):
                    Nv[:, c::d, c] = N          # a_vec = a*d + c
                    dNv[:, c::d, c, :] = dN
                self._tab[key] = (self.t(Nv), self.t(dNv))
            else:
                self._tab[key] = (self.t(N), self.t(dN))
        return self._tab[key]

    def phys_coords(self):
        if self._phys is None:
            orig = self.mesh.cell_origins()       # (E,ndim) numpy
            self._phys = tuple(
                self.t(orig[:, None, i] + self.qpts[None, :, i] * self._h[i])
                for i in range(self.ndim))
        return self._phys

    def coef_at_q(self, f, deriv=False):
        """Coefficient values (E,Q[,dim]) or gradients (E,Q[,dim],2)."""
        sp = f.function_space()
        key = (id(f.parent) if isinstance(f, _SubView) else id(f),
               getattr(f, "i", None), deriv)
        if key in self._coef:
            return self._coef[key]
        N, dN = self.tab(sp)
        if id(f) in self.coef_override:
            fe = self.coef_override[id(f)]
        else:
            fe = sp.gather(f.data.to(self.dtype))      # (E, nloc)
        if sp.dim is None:
            out = (torch.einsum("qad,ea->eqd", dN, fe) if deriv
                   else torch.einsum("qa,ea->eq", N, fe))
        else:
            out = (torch.einsum("qacd,ea->eqcd", dN, fe) if deriv
                   else torch.einsum("qac,ea->eqc", N, fe))
        self._coef[key] = out
        return out


def _pad_v(arr, vrank):
    """Give ``arr`` (with axes E,Q,A,B already) ``vrank`` trailing axes."""
    return arr[(...,) + (None,) * vrank] if vrank else arr


def _trace(a):
    return torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)


def _qeval(e, ctx):
    """Evaluate expression -> tensor with axes (E,Q,A,B,*e.shape), axes of
    size 1 where absent."""
    if isinstance(e, X.Argument):
        N, _ = ctx.tab(e.space)        # scalar: (Q, nloc); vector (Q,nloc,d)
        if e.space.dim is None:
            v = N[None, :, :, None] if e.number == 1 else N[None, :, None, :]
        else:
            v = (N[None, :, :, None, :] if e.number == 1
                 else N[None, :, None, :, :])
        return v
    if isinstance(e, X.Grad) and isinstance(e.a, X.Argument):
        _, dN = ctx.tab(e.a.space)     # scalar (Q,nloc,2); vector (Q,nloc,d,2)
        if e.a.space.dim is None:
            return (dN[None, :, :, None, :] if e.a.number == 1
                    else dN[None, :, None, :, :])
        return (dN[None, :, :, None, :, :] if e.a.number == 1
                else dN[None, :, None, :, :, :])
    if isinstance(e, X.Div) and isinstance(e.a, X.Argument):
        return _trace(_qeval(X.Grad(e.a), ctx))
    if isinstance(e, (Function, _SubView)):
        v = ctx.coef_at_q(e)           # (E,Q[,d])
        return v[:, :, None, None] if e.shape == () else v[:, :, None, None, :]
    if isinstance(e, X.Grad) and isinstance(e.a, (Function, _SubView)):
        v = ctx.coef_at_q(e.a, deriv=True)
        return (v[:, :, None, None, :] if e.a.shape == ()
                else v[:, :, None, None, :, :])
    if isinstance(e, X.Div) and isinstance(e.a, (Function, _SubView)):
        v = ctx.coef_at_q(e.a, deriv=True)      # (E,Q,d,2)
        return _trace(v)[:, :, None, None]
    if e.spatial_only and (e.has_coord or isinstance(e, (X.Grad, X.Div))):
        v = _eval_spatial(e, *ctx.phys_coords())  # (E,Q,*shape)
        return v[:, :, None, None] if e.shape == () else \
            v[(slice(None), slice(None), None, None) + (...,)]
    if isinstance(e, (X.ScalarLiteral, X.Constant)):
        return ctx.t(e.value)[None, None, None, None]
    if isinstance(e, X.Sum):
        return _qeval(e.a, ctx) + _qeval(e.b, ctx)
    if isinstance(e, X.Product):
        if (e.a.has_trial and e.b.has_trial) or \
           (e.a.has_test and e.b.has_test):
            raise ValueError("form is nonlinear in an argument")
        va, vb = _qeval(e.a, ctx), _qeval(e.b, ctx)
        va = _pad_v(va, len(e.b.shape)) if e.a.shape == () else va
        vb = _pad_v(vb, len(e.a.shape)) if e.b.shape == () else vb
        return va * vb
    if isinstance(e, X.Pow):
        return _qeval(e.a, ctx) ** e.p
    if isinstance(e, X.MathFn):
        return _MATH_FNS[e.fn_name](_qeval(e.a, ctx))
    if isinstance(e, X.Indexed):
        v = _qeval(e.a, ctx)
        return v[(slice(None),) * 4 + (e.i,)]
    if isinstance(e, X.AsVector):
        comps = torch.broadcast_tensors(*[_qeval(c, ctx) for c in e.comps])
        return torch.stack(comps, dim=-1)
    if isinstance(e, X.Inner):
        if (e.a.has_trial and e.b.has_trial) or \
           (e.a.has_test and e.b.has_test):
            raise ValueError("form is nonlinear in an argument")
        va, vb = _qeval(e.a, ctx), _qeval(e.b, ctx)
        vrank = len(e.a.shape)
        if vrank == 0:
            return va * vb
        return torch.sum(va * vb, dim=tuple(range(-vrank, 0)))
    if isinstance(e, X.Dot):
        if (e.a.has_trial and e.b.has_trial) or \
           (e.a.has_test and e.b.has_test):
            raise ValueError("form is nonlinear in an argument")
        va, vb = _qeval(e.a, ctx), _qeval(e.b, ctx)
        ra, rb = len(e.a.shape), len(e.b.shape)
        # align the contracted axis k of both operands at position -rb
        va_e = va[(...,) + (None,) * (rb - 1)]
        vb_e = vb[(slice(None),) * 4 + (None,) * (ra - 1) + (...,)]
        return torch.sum(va_e * vb_e, dim=-rb)
    if isinstance(e, X.Conditional):
        ca, cb = _qeval(e.cond.a, ctx), _qeval(e.cond.b, ctx)
        return torch.where(_CMP_FNS[e.cond.op](ca, cb),
                           _qeval(e.t, ctx), _qeval(e.f, ctx))
    if isinstance(e, X.Grad) and isinstance(e.a, X.Sum):
        return _qeval(X.Grad(e.a.a), ctx) + _qeval(X.Grad(e.a.b), ctx)
    if isinstance(e, X.Grad) and isinstance(e.a, X.Product) and \
            e.a.a.shape == () and e.a.a.spatial_only and \
            not e.a.a.has_coord:
        return _qeval(e.a.a, ctx)[..., None] * _qeval(X.Grad(e.a.b), ctx)
    if isinstance(e, X.Div) and isinstance(e.a, X.Sum):
        return _qeval(X.Div(e.a.a), ctx) + _qeval(X.Div(e.a.b), ctx)
    if isinstance(e, X.Div) and isinstance(e.a, X.Product) and \
            e.a.a.shape == () and e.a.a.spatial_only and \
            not e.a.a.has_coord:
        return _qeval(e.a.a, ctx) * _qeval(X.Div(e.a.b), ctx)
    if isinstance(e, X.Grad) and isinstance(e.a, X.AsVector):
        comps = torch.broadcast_tensors(
            *[_qeval(X.Grad(c), ctx) for c in e.a.comps])
        return torch.stack(comps, dim=-2)
    raise NotImplementedError(f"_qeval: {type(e).__name__}")


# ---------------------------------------------------------------------------
# assemble
# ---------------------------------------------------------------------------

def _form_spaces(form):
    spaces = []

    def visit(e):
        if isinstance(e, (X.Argument, Function, _SubView)):
            sp = e.function_space()
            if sp not in spaces:
                spaces.append(sp)
        for o in e.operands:
            visit(o)

    for e, _ in form.integrals:
        visit(e)
    return spaces


def _integrand(form, ctx):
    acc = None
    for e, m in form.integrals:
        if m is not dx and m.name != "dx":
            raise NotImplementedError("only cell integrals (dx) supported")
        v = _qeval(e, ctx)
        if e.shape != ():
            raise ValueError("integrand must be scalar")
        acc = v if acc is None else acc + v
    return acc


def element_tensor(form, quad_degree=None, coef_override=None):
    """Per-element tensor of a form BEFORE scatter: (E|1, b) for linear
    forms, (E|1, b, a) for bilinear."""
    trial = form.trial_space()
    test = form.test_space()
    spaces = _form_spaces(form)
    mesh = spaces[0].mesh
    nq1d = (max(s.degree for s in spaces) + 2 if quad_degree is None
            else quad_degree)
    ctx = _QCtx(mesh, nq1d, mesh.dtype, coef_override=coef_override)
    acc = _integrand(form, ctx)
    if trial is not None and test is not None:
        return torch.einsum("q,eqab->eba", ctx.w_phys, acc)
    if test is not None:
        return torch.einsum("q,eqb->eb", ctx.w_phys, acc[:, :, 0, :])
    raise ValueError("element_tensor needs a test function")


def assemble(form, bcs=None, quad_degree=None,
             form_compiler_parameters=None):
    """Assemble a form.

    * bilinear (trial+test)  -> LocalOp (MaskedOp when ``bcs`` given)
    * linear (test only)     -> Cofunction
    * functional             -> 0-d tensor
    """
    if not isinstance(form, Form):
        raise TypeError("assemble expects a Form")
    trial = form.trial_space()
    test = form.test_space()
    spaces = _form_spaces(form)
    if not spaces:
        raise ValueError("form has no FEM content")
    mesh = spaces[0].mesh
    nq1d = (max(s.degree for s in spaces) + 2 if quad_degree is None
            else quad_degree)
    ctx = _QCtx(mesh, nq1d, mesh.dtype)
    acc = _integrand(form, ctx)

    if trial is not None and test is not None:
        # (E,Q,A,B) -> local matrices (E, b, a)
        A = torch.einsum("q,eqab->eba", ctx.w_phys, acc)
        op = LocalOp(A, trial, test)
        if bcs:
            if isinstance(bcs, DirichletBC):
                bcs = (bcs,)
            op = MaskedOp(op, combine_masks(trial, bcs))
        return op
    if test is not None:
        r = torch.einsum("q,eqb->eb", ctx.w_phys, acc[:, :, 0, :])
        r = r.expand(mesh.n_cells, r.shape[-1])
        out = Cofunction(test)
        out.data = test.scatter_add(r)
        if bcs:
            if isinstance(bcs, DirichletBC):
                bcs = (bcs,)
            for bc in bcs:
                out.data = torch.where(bc.mask, 0.0, out.data)
        return out
    if trial is not None:
        raise ValueError("form has a trial but no test function")
    ones = torch.ones((mesh.n_cells, ctx.Q), dtype=mesh.dtype,
                      device=mesh.device)
    return torch.einsum("q,eq->", ctx.w_phys, acc[:, :, 0, 0] * ones)
