"""Port's ServeEngine on the hybrid family (Jamba without experts) vs the
JAX package's, on the CPU.

The reference engine splices every cache entry along axis 1, but the
hybrid ``conv``/``ssm`` keep batch on axis 2, so on more than one slot it
puts each request's Mamba state in the wrong place.  The port splices
each entry along its own batch axis and is held, on 2 and 4 slots, to the
reference run one request at a time (one slot, where the reference's
splice is right).  Same tiny config and f32 parity as
``test_torch_hybrid.py``.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import numpy as np

from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.models import prefill
from repro_torch.serve.engine import Request, ServeEngine
from _torch_parity import configs, f32, params

ARCH = "jamba-1.5-large-398b"
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_KEYS = ("k", "v", "conv", "ssm")
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13, 14, 15, 16], [20, 21],
           [30, 31, 32, 33]]


def _configs(**kw):
    return configs(ARCH, moe=None, **kw)


def _serve(engine_cls, request_cls, cfg, p, prompts, *, slots, max_len=64,
           max_new=6, **kw):
    eng = engine_cls(cfg, p, slots=slots, max_len=max_len, **kw)
    for i, pr in enumerate(prompts):
        eng.add_request(request_cls(rid=i, prompt=pr, max_new_tokens=max_new))
    eng.run_until_done()
    return eng



def test_engine_one_slot_matches_jax_engine():
    """One slot: the reference engine splices into slot 0, where its
    batch-axis mistake does no harm; same greedy tokens, same state."""
    jcfg, tcfg = _configs(dtype="float32")
    jp, tp = params(jcfg, tcfg)
    je = _serve(JServeEngine, JRequest, jcfg, jp, PROMPTS, slots=1)
    te = _serve(ServeEngine, Request, tcfg, tp, PROMPTS, slots=1,
                device="cpu")
    for i in range(len(PROMPTS)):
        assert te.requests[i].output == je.requests[i].output, i
        assert te.requests[i].done
    for name in CACHE_KEYS:
        np.testing.assert_allclose(f32(te.cache[name]), f32(je.cache[name]),
                                   **TOL)


@pytest.mark.parametrize("slots", [2, 4])
def test_engine_many_slots_match_reference_one_request_at_a_time(slots):
    jcfg, tcfg = _configs(dtype="float32")
    jp, tp = params(jcfg, tcfg)
    je = _serve(JServeEngine, JRequest, jcfg, jp, PROMPTS, slots=1)
    te = _serve(ServeEngine, Request, tcfg.replace(scan_impl="pallas"), tp,
                PROMPTS, slots=slots, device="cpu")
    for i in range(len(PROMPTS)):
        assert te.requests[i].output == je.requests[i].output, i
    assert te.tokens_generated == je.tokens_generated


def test_splice_cache_writes_one_slot_along_axis_2():
    """Admitting a request into slot 1 writes its conv/ssm state at batch
    axis 2 and its k/v at axis 1, and no other slot."""
    _, cfg = _configs(dtype="float32")
    _, p = params(*_configs(dtype="float32"))
    eng = ServeEngine(cfg, p, slots=3, max_len=16, device="cpu")
    eng.slot_states[0].active = True              # slot 0 busy -> slot 1
    eng.add_request(Request(rid=0, prompt=[4, 5, 6, 7], max_new_tokens=2))
    eng._admit()
    _, one = prefill(cfg, p, {"tokens": torch.tensor([[4, 5, 6, 7]]),
                              "positions": torch.arange(4)[None]}, max_len=16)
    for name, axis in (("k", 1), ("v", 1), ("conv", 2), ("ssm", 2)):
        pool = eng.cache[name]
        assert torch.equal(pool.narrow(axis, 1, 1), one[name]), name
        for other in (0, 2):
            assert float(pool.narrow(axis, other, 1).abs().sum()) == 0.0
    assert eng.cache["index"].tolist() == [0, 4, 0]


def test_reference_caveat_engine_misplaces_hybrid_state_on_two_slots():
    """Documents the REFERENCE, not the port: its engine splices every
    cache entry along axis 1, but the hybrid conv/ssm keep batch on axis
    2, and ``dynamic_update_slice`` clamps the start, so each admitted
    request's Mamba state lands in slot 0.  Two prompts served together
    then diverge from the same prompts served one at a time after the
    first token (which prefill makes).  ROADMAP lists the caveat; the
    port's engine is held to the one-at-a-time tokens above."""
    jcfg, tcfg = _configs(dtype="float32")
    jp, _ = params(jcfg, tcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist() for n in (12, 20)]
    together = _serve(JServeEngine, JRequest, jcfg, jp, prompts, slots=2,
                      max_new=8)
    alone = _serve(JServeEngine, JRequest, jcfg, jp, prompts, slots=1,
                   max_new=8)
    for i in range(2):
        a, b = together.requests[i].output, alone.requests[i].output
        assert a[0] == b[0] and a != b, (i, a, b)
