from .ipm import IPMResult, solve_lp  # noqa: F401
from .bnb import MILPResult, solve_milp  # noqa: F401
