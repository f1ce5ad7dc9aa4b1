from repro_torch.serve.engine import Request, ServeEngine, SlotState  # noqa: F401
