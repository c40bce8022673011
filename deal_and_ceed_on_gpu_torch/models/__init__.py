from .helmholtz import HelmholtzOperator, default_coefficient
from .operator_base import MatrixFreeOperator, assemble_rhs, l2_norm_function, tensor_product_diagonal
from .poisson import PoissonOperator

__all__ = [
    "HelmholtzOperator",
    "MatrixFreeOperator",
    "PoissonOperator",
    "assemble_rhs",
    "default_coefficient",
    "l2_norm_function",
    "tensor_product_diagonal",
]
