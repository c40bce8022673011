from .bp import BP_SPECS, BPSpec, make_bp_operator
from .helmholtz import HelmholtzOperator, default_coefficient
from .mass import MassOperator
from .operator_base import MatrixFreeOperator, assemble_dense, assemble_rhs, l2_norm_function, tensor_product_diagonal
from .poisson import PoissonOperator
from .vector import VectorOperator

__all__ = [
    "BPSpec",
    "BP_SPECS",
    "HelmholtzOperator",
    "MassOperator",
    "MatrixFreeOperator",
    "PoissonOperator",
    "VectorOperator",
    "assemble_dense",
    "assemble_rhs",
    "default_coefficient",
    "l2_norm_function",
    "make_bp_operator",
    "tensor_product_diagonal",
]
