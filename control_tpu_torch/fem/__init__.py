"""FEM layer: structured meshes, Lagrange spaces, a UFL-like form language
and batched matrix-free assembly."""

from .mesh import (StructuredMesh2D, StructuredMesh3D, UnitSquareMesh,
                   RectangleMesh, UnitCubeMesh, BoxMesh)
from .space import (FunctionSpace, VectorFunctionSpace, Function, Cofunction,
                    MixedFunction, DirichletBC, homogenize)
from .expr import (TrialFunction, TestFunction, SpatialCoordinate, Constant,
                   grad, div, inner, dot, as_vector, sin, cos, tan, exp,
                   sqrt, tanh, pi, conditional, ge, le, gt, lt)
from .forms import dx, ds, Form, action, adjoint
from .assemble import assemble, interpolate, eval_at_points

__all__ = [
    "StructuredMesh2D", "StructuredMesh3D", "UnitSquareMesh",
    "RectangleMesh", "UnitCubeMesh", "BoxMesh",
    "FunctionSpace", "VectorFunctionSpace", "Function", "Cofunction",
    "MixedFunction", "DirichletBC", "homogenize",
    "TrialFunction", "TestFunction", "SpatialCoordinate", "Constant",
    "grad", "div", "inner", "dot", "as_vector", "sin", "cos", "tan", "exp",
    "sqrt", "tanh", "pi", "conditional", "ge", "le", "gt", "lt",
    "dx", "ds", "Form", "action", "adjoint",
    "assemble", "interpolate", "eval_at_points",
]
