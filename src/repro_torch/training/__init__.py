from .optimizer import AdamWConfig, adamw_update, init_opt_state  # noqa: F401
from .train_lib import compile_train_step, make_train_step, TrainState  # noqa: F401
