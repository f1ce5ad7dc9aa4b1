"""Training on the port (``repro/train``): the train and eval steps, the
``Trainer`` loop with write-behind checkpoints over the fabric, and the
fault monitor (a copy of the reference's ``fault.py``)."""
from repro_torch.train.step import (  # noqa: F401
    make_train_step, make_eval_step, make_opt_state,
)
from repro_torch.train.loop import Trainer, TrainResult  # noqa: F401
from repro_torch.train.fault import FaultMonitor, FaultEvent  # noqa: F401
