from .optimizer import (  # noqa: F401
    OptConfig,
    adamw_update,
    init_opt_state,
    opt_state_logical,
)
from .train_step import make_train_step  # noqa: F401
