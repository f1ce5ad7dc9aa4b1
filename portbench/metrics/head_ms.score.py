"""Device ms a unit of the head: the ``logits`` span (final norm and
unembedding, ``models/model.py`` ``_logits``) and the ``loss`` span (the
f32 logsumexp, the target's logit and the sums, ``loss_fn``)."""
from portbench.metrics._spans import ms_a_unit


def read(t):
    return ms_a_unit(t, ["logits", "loss"])
