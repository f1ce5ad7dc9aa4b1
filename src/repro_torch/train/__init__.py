"""Training steps of the port (``repro/train``).  The ``Trainer`` loop and
the fault monitor wait for ROADMAP port slice (b2)."""
from repro_torch.train.step import (  # noqa: F401
    make_train_step, make_eval_step, make_opt_state,
)
