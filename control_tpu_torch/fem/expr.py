"""A small symbolic form language (the reference's UFL surface).

The reference defines problems through UFL callables such as

    def forw_diff_operator(trial, test, u, t):
        return inner(grad(trial), grad(test)) * dx

(reference README.md:31, test/test_control.py:34,1251).  This module provides
the same vocabulary -- ``TrialFunction/TestFunction/SpatialCoordinate/grad/
div/inner/dot/dx/as_vector/Constant`` and elementary functions -- as a tiny
AST.  Lowering to batched element tensors happens in
:mod:`control_tpu_torch.fem.assemble`; spatial-only subtrees (no arguments, no FEM
functions) are differentiated exactly with torch.func autodiff, which replaces UFL's
symbolic differentiation of manufactured solutions
(e.g. ``v_d.interpolate(-div(grad(zeta)) + v)``,
reference test/test_control.py:147).
"""

import numpy as np

pi = float(np.pi)


class Expr:
    """Base class for expression nodes.

    Attributes (computed in subclasses):
      shape        value shape: () scalar, (2,) vector, (2,2) tensor
      has_trial / has_test / has_function / has_coord  -- terminal content
    """

    shape = ()
    has_trial = False
    has_test = False
    has_function = False
    has_coord = False

    @property
    def spatial_only(self):
        return not (self.has_trial or self.has_test or self.has_function)

    # -- operator sugar -----------------------------------------------------
    def __add__(self, other):
        return Sum(self, as_expr(other))

    def __radd__(self, other):
        return Sum(as_expr(other), self)

    def __sub__(self, other):
        return Sum(self, Product(as_expr(-1.0), as_expr(other)))

    def __rsub__(self, other):
        return Sum(as_expr(other), Product(as_expr(-1.0), self))

    def __mul__(self, other):
        from .forms import Measure, Form
        if isinstance(other, Measure):
            return Form([(self, other)])
        if isinstance(other, Form):
            raise TypeError("cannot multiply Expr by Form")
        return Product(self, as_expr(other))

    def __rmul__(self, other):
        return Product(as_expr(other), self)

    def __truediv__(self, other):
        return Product(self, Pow(as_expr(other), -1.0))

    def __rtruediv__(self, other):
        return Product(as_expr(other), Pow(self, -1.0))

    def __pow__(self, p):
        return Pow(self, p)

    def __neg__(self):
        return Product(as_expr(-1.0), self)

    def __pos__(self):
        return self

    def __getitem__(self, i):
        return Indexed(self, i)

    def __iter__(self):
        if len(self.shape) != 1:
            raise TypeError("only vector expressions are iterable")
        return iter(self[i] for i in range(self.shape[0]))

    def __len__(self):
        if len(self.shape) != 1:
            raise TypeError("len() only for vector expressions")
        return self.shape[0]

    @property
    def operands(self):
        return ()

    def _inherit(self, *ops):
        self.has_trial = any(o.has_trial for o in ops)
        self.has_test = any(o.has_test for o in ops)
        self.has_function = any(o.has_function for o in ops)
        self.has_coord = any(o.has_coord for o in ops)


def as_expr(v):
    if isinstance(v, Expr):
        return v
    if isinstance(v, (int, float, np.floating, np.integer)):
        return ScalarLiteral(float(v))
    # tensor scalars and 0-d arrays
    return ScalarLiteral(v)


# ---------------------------------------------------------------------------
# terminals
# ---------------------------------------------------------------------------

class ScalarLiteral(Expr):
    def __init__(self, value):
        self.value = value


class Constant(Expr):
    """Mutable scalar constant (reference uses firedrake.Constant for time).

    The value may be a python float or a 0-d tensor.
    """

    def __init__(self, value):
        self.value = value

    def assign(self, value):
        self.value = value

    def __float__(self):
        return float(self.value)


class Argument(Expr):
    def __init__(self, space, number):
        self.space = space
        self.number = number           # 0 = test, 1 = trial (UFL convention)
        self.shape = space.value_shape
        if number == 0:
            self.has_test = True
        else:
            self.has_trial = True

    def function_space(self):
        return self.space


def TestFunction(space):
    return Argument(space, 0)


def TrialFunction(space):
    return Argument(space, 1)


class SpatialX(Expr):
    """One coordinate component (x: i=0, y: i=1, z: i=2)."""

    has_coord = True

    def __init__(self, mesh, i):
        self.mesh = mesh
        self.i = i


class SpatialCoordinate(Expr):
    has_coord = True

    def __init__(self, mesh):
        self.mesh = mesh
        self.ndim = getattr(mesh, "ndim", 2)
        self.shape = (self.ndim,)

    def __getitem__(self, i):
        return SpatialX(self.mesh, i)

    def __iter__(self):
        return iter(tuple(SpatialX(self.mesh, i) for i in range(self.ndim)))

    def __len__(self):
        return self.ndim


# ---------------------------------------------------------------------------
# compound nodes
# ---------------------------------------------------------------------------

class Sum(Expr):
    def __init__(self, a, b):
        if a.shape != b.shape:
            raise ValueError(f"shape mismatch in sum: {a.shape} vs {b.shape}")
        self.a, self.b = a, b
        self.shape = a.shape
        self._inherit(a, b)

    @property
    def operands(self):
        return (self.a, self.b)


class Product(Expr):
    """Product where at least one factor is scalar."""

    def __init__(self, a, b):
        if a.shape != () and b.shape != ():
            raise ValueError("Product needs at least one scalar factor; "
                             "use inner/dot/outer for tensor products")
        self.a, self.b = a, b
        self.shape = a.shape if a.shape != () else b.shape
        self._inherit(a, b)
        if sum((a.has_trial, a.has_test)) and sum((b.has_trial, b.has_test)):
            # products of two argument-carrying factors arise only through
            # inner/dot which handle the bilinear bookkeeping
            pass

    @property
    def operands(self):
        return (self.a, self.b)


class Pow(Expr):
    def __init__(self, a, p):
        if a.shape != ():
            raise ValueError("Pow only for scalars")
        if a.has_trial or a.has_test:
            raise ValueError("Pow of trial/test functions is not linear")
        self.a = a
        self.p = float(p) if not isinstance(p, Expr) else p
        self._inherit(a)

    @property
    def operands(self):
        return (self.a,)


class Indexed(Expr):
    def __init__(self, a, i):
        if len(a.shape) == 0:
            raise ValueError("cannot index a scalar")
        self.a, self.i = a, int(i)
        self.shape = a.shape[1:]
        self._inherit(a)

    @property
    def operands(self):
        return (self.a,)


class AsVector(Expr):
    def __init__(self, comps):
        comps = [as_expr(c) for c in comps]
        for c in comps:
            if c.shape != ():
                raise ValueError("as_vector components must be scalars")
        self.comps = tuple(comps)
        self.shape = (len(comps),)
        self._inherit(*comps)

    @property
    def operands(self):
        return self.comps


def as_vector(comps):
    return AsVector(comps)


def _expr_ndim(e):
    """Spatial dimension of the mesh an expression lives on (default 2)."""
    if hasattr(e, "space"):
        return getattr(e.space, "ndim", 2)
    if hasattr(e, "mesh"):
        return getattr(e.mesh, "ndim", 2)
    for o in e.operands:
        nd = _expr_ndim(o)
        if nd is not None:
            return nd
    return None


class Grad(Expr):
    def __init__(self, a):
        if len(a.shape) > 1:
            raise ValueError("grad of tensors not supported")
        self.a = a
        nd = _expr_ndim(a) or 2
        self.shape = a.shape + (nd,)
        self._inherit(a)

    @property
    def operands(self):
        return (self.a,)


class Div(Expr):
    def __init__(self, a):
        nd = _expr_ndim(a) or 2
        if a.shape != (nd,):
            raise ValueError(f"div expects a {nd}-vector")
        self.a = a
        self.shape = ()
        self._inherit(a)

    @property
    def operands(self):
        return (self.a,)


class Inner(Expr):
    """Full contraction of equal-shaped operands."""

    def __init__(self, a, b):
        a, b = as_expr(a), as_expr(b)
        if a.shape != b.shape:
            raise ValueError(f"inner shape mismatch {a.shape} vs {b.shape}")
        self.a, self.b = a, b
        self.shape = ()
        self._inherit(a, b)

    @property
    def operands(self):
        return (self.a, self.b)


class Dot(Expr):
    """Contract last axis of a with first axis of b."""

    def __init__(self, a, b):
        a, b = as_expr(a), as_expr(b)
        if len(a.shape) == 0 or len(b.shape) == 0:
            raise ValueError("dot expects tensor operands")
        if a.shape[-1] != b.shape[0]:
            raise ValueError(f"dot shape mismatch {a.shape} vs {b.shape}")
        self.a, self.b = a, b
        self.shape = a.shape[:-1] + b.shape[1:]
        self._inherit(a, b)

    @property
    def operands(self):
        return (self.a, self.b)


class MathFn(Expr):
    def __init__(self, fn_name, a):
        a = as_expr(a)
        if a.shape != ():
            raise ValueError("math functions act on scalars")
        if a.has_trial or a.has_test:
            raise ValueError("nonlinear function of trial/test function")
        self.fn_name = fn_name
        self.a = a
        self._inherit(a)

    @property
    def operands(self):
        return (self.a,)


class Conditional(Expr):
    """conditional(cond_expr, true_val, false_val); cond built via ge/le/gt/lt."""

    def __init__(self, cond, t, f):
        self.cond = cond
        self.t, self.f = as_expr(t), as_expr(f)
        if self.t.shape != self.f.shape:
            raise ValueError("conditional branch shape mismatch")
        self.shape = self.t.shape
        self._inherit(self.t, self.f, cond.a, cond.b)

    @property
    def operands(self):
        return (self.t, self.f, self.cond.a, self.cond.b)


class Comparison:
    def __init__(self, op, a, b):
        self.op = op
        self.a, self.b = as_expr(a), as_expr(b)


def ge(a, b):
    return Comparison("ge", a, b)


def le(a, b):
    return Comparison("le", a, b)


def gt(a, b):
    return Comparison("gt", a, b)


def lt(a, b):
    return Comparison("lt", a, b)


def conditional(cond, t, f):
    return Conditional(cond, t, f)


# public function constructors ------------------------------------------------

def grad(a):
    return Grad(as_expr(a))


def div(a):
    return Div(as_expr(a))


def inner(a, b):
    return Inner(a, b)


def dot(a, b):
    return Dot(a, b)


def sin(a):
    return MathFn("sin", a)


def cos(a):
    return MathFn("cos", a)


def tan(a):
    return MathFn("tan", a)


def exp(a):
    return MathFn("exp", a)


def sqrt(a):
    return MathFn("sqrt", a)


def tanh(a):
    return MathFn("tanh", a)


def abs_(a):
    return MathFn("abs", a)
