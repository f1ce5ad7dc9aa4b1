from repro_torch.serve.engine import (  # noqa: F401
    Request, ServeEngine, SlotState, check_servable,
)
