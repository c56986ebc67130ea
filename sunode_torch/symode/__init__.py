from sunode_torch.symode.problem import SympyProblem
from sunode_torch.symode.lambdify import (
    CardinalBSpline,
    dexpit,
    expit,
    explog_opt,
    interpolate_spline,
    lambdify_torch,
    logaddexp,
    stabilize_exp_products,
)

__all__ = [
    "SympyProblem",
    "lambdify_torch",
    "logaddexp",
    "expit",
    "dexpit",
    "CardinalBSpline",
    "interpolate_spline",
    "explog_opt",
    "stabilize_exp_products",
]
