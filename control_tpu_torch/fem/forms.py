"""Forms (integrals of expressions) and form algebra.

Mirrors the slice of UFL the reference exercises: cell integrals ``expr*dx``,
form sums, scalar scaling, ``action`` (replace trial function by a
coefficient; reference control/control.py:330,425) and ``adjoint`` (swap
trial/test; reference control/control.py:518).
"""

from .expr import Expr, Argument, Sum, Product, as_expr


class Measure:
    def __init__(self, name):
        self.name = name

    def __rmul__(self, integrand):
        if not isinstance(integrand, Expr):
            integrand = as_expr(integrand)
        return Form([(integrand, self)])


dx = Measure("dx")
ds = Measure("ds")   # boundary measure: accepted, assembled only when needed


class Form:
    """A sum of integrals.  Supports +, -, scalar *."""

    def __init__(self, integrals):
        self.integrals = list(integrals)

    def __add__(self, other):
        if isinstance(other, Form):
            return Form(self.integrals + other.integrals)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, Form):
            return self + (-1.0) * other
        return NotImplemented

    def __mul__(self, s):
        return Form([(Product(as_expr(s), e), m) for e, m in self.integrals])

    def __rmul__(self, s):
        return self.__mul__(s)

    def __neg__(self):
        return self * (-1.0)

    # introspection ---------------------------------------------------------
    def _spaces(self, number):
        spaces = []

        def visit(e):
            if isinstance(e, Argument) and e.number == number:
                if e.space not in spaces:
                    spaces.append(e.space)
            for o in e.operands:
                visit(o)

        for e, _ in self.integrals:
            visit(e)
        return spaces

    def trial_space(self):
        s = self._spaces(1)
        if len(s) > 1:
            raise ValueError("multiple trial spaces in form")
        return s[0] if s else None

    def test_space(self):
        s = self._spaces(0)
        if len(s) > 1:
            raise ValueError("multiple test spaces in form")
        return s[0] if s else None

    def arguments(self):
        """(test, trial) arguments for API parity."""
        out = []
        ts = self.test_space()
        tr = self.trial_space()
        if ts is not None:
            out.append(Argument(ts, 0))
        if tr is not None:
            out.append(Argument(tr, 1))
        return tuple(out)

    def map_expr(self, fn):
        return Form([(fn(e), m) for e, m in self.integrals])


def replace_terminals(e, mapping):
    """Rebuild expression ``e`` with terminals replaced per ``mapping``
    (a callable terminal -> replacement or None)."""
    from . import expr as X

    r = mapping(e)
    if r is not None:
        return r
    if isinstance(e, X.Sum):
        return X.Sum(replace_terminals(e.a, mapping),
                     replace_terminals(e.b, mapping))
    if isinstance(e, X.Product):
        return X.Product(replace_terminals(e.a, mapping),
                         replace_terminals(e.b, mapping))
    if isinstance(e, X.Pow):
        return X.Pow(replace_terminals(e.a, mapping), e.p)
    if isinstance(e, X.Indexed):
        return X.Indexed(replace_terminals(e.a, mapping), e.i)
    if isinstance(e, X.AsVector):
        return X.AsVector([replace_terminals(c, mapping) for c in e.comps])
    if isinstance(e, X.Grad):
        return X.Grad(replace_terminals(e.a, mapping))
    if isinstance(e, X.Div):
        return X.Div(replace_terminals(e.a, mapping))
    if isinstance(e, X.Inner):
        return X.Inner(replace_terminals(e.a, mapping),
                       replace_terminals(e.b, mapping))
    if isinstance(e, X.Dot):
        return X.Dot(replace_terminals(e.a, mapping),
                     replace_terminals(e.b, mapping))
    if isinstance(e, X.MathFn):
        return X.MathFn(e.fn_name, replace_terminals(e.a, mapping))
    if isinstance(e, X.Conditional):
        cond = X.Comparison(e.cond.op,
                            replace_terminals(e.cond.a, mapping),
                            replace_terminals(e.cond.b, mapping))
        return X.Conditional(cond,
                             replace_terminals(e.t, mapping),
                             replace_terminals(e.f, mapping))
    # terminals (ScalarLiteral, Constant, Argument, SpatialX, Function, ...)
    return e


def action(form, u):
    """Replace the trial function of ``form`` by coefficient ``u``."""
    def mapping(e):
        if isinstance(e, Argument) and e.number == 1:
            if u.space is not e.space and u.space != e.space:
                raise ValueError("action coefficient space mismatch")
            return u
        return None

    return form.map_expr(lambda e: replace_terminals(e, mapping))


def adjoint(form):
    """Swap trial and test functions."""
    def mapping(e):
        if isinstance(e, Argument):
            return Argument(e.space, 1 - e.number)
        return None

    return form.map_expr(lambda e: replace_terminals(e, mapping))
