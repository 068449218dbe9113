from .optimizer import OptConfig, adamw_update, init_opt_state  # noqa: F401
from .train_step import make_train_step  # noqa: F401
