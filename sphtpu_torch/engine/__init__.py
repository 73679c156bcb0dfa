from .config import (  # noqa: F401
    EngineConfig,
    Params,
    State,
    config_from_reference,
    params_from_numpy,
    state_from_numpy,
)
from .step import make_chunk_runner, make_step  # noqa: F401
from .driver import run_simulation  # noqa: F401
