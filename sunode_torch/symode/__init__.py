from sunode_torch.symode.problem import SympyProblem
from sunode_torch.symode.lambdify import (
    lambdify_torch,
    logaddexp,
    expit,
    dexpit,
)

__all__ = [
    "SympyProblem",
    "lambdify_torch",
    "logaddexp",
    "expit",
    "dexpit",
]
