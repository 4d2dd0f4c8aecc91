"""For the tests of models/deepseek_v3.py in bf16: the program's routers
held to the fp32 reference's choices, so that what is left between the
two is rounding. Left free, a bf16 router chooses another expert than the
fp32 one for a token whose k-th and (k+1)-th scores lie within bf16's
rounding, and that token's expert output changes whole."""

import contextlib
from unittest import mock

import torch

import reference_deepseek_v3 as ref
from rag_icd10_tpu_torch.models import deepseek_v3 as dv


@contextlib.contextmanager
def held_to_reference(w, calls, cfg, hidden=None):
    """While open, every ``Router`` of the program returns the experts the
    reference (``tests/reference_deepseek_v3.py``, over ``w`` and ``cfg``;
    ``hidden``: another reference's forward that routes through its
    ``route``) chose for the same tokens, with the program's own weights of
    them. ``calls``: the ids of each of the program's model calls, in order.
    Yields the list of the program's own choices, filled as it runs."""
    picks, chosen, route, forward = [], [], ref.route, dv.Router.forward

    def record(*a):
        idx, weight = route(*a)
        picks.append(idx)
        return idx, weight

    with torch.no_grad(), mock.patch.object(ref, "route", record):
        for ids in calls:
            (hidden or ref.hidden)(w, ids, cfg)

    def held(self, x):
        idx, _ = forward(self, x)
        chosen.append(idx)
        idx = picks.pop(0).to(idx.device)
        scores = torch.sigmoid(torch.nn.functional.linear(x.float(), self.weight.float()))
        weight = scores.gather(1, idx)
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
        return idx, weight * self.arch.routed_scaling_factor

    with mock.patch.object(dv.Router, "forward", held):
        yield chosen
    assert not picks, f"{len(picks)} reference choices left unused"
