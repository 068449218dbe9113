from .model import (  # noqa: F401
    abstract_params,
    count_params,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    loss_fn,
    param_logical,
    param_shape_dtypes,
    prefill,
)

__all__ = [
    "abstract_params", "count_params", "decode_step", "forward",
    "init_decode_state", "init_params", "loss_fn", "param_logical",
    "param_shape_dtypes", "prefill",
]
