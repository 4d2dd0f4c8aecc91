"""For the tests of models/deepseek_v3.py in bf16: the program's routers
held to the fp32 reference's choices, so that what is left between the
two is rounding. Left free, a bf16 router chooses another expert than the
fp32 one for a token whose k-th and (k+1)-th scores lie within bf16's
rounding, and that token's expert output changes whole."""

import contextlib
import hashlib
from unittest import mock

import torch

import reference_deepseek_v3 as ref
from rag_icd10_tpu_torch.models import deepseek_v3 as dv


def _key(router, x):
    """A router and the bytes of its input: a checkpoint's recomputation in
    the backward gives the router the same input again."""
    return id(router), hashlib.sha1(x.detach().float().cpu().numpy().tobytes()).digest()


@contextlib.contextmanager
def recorded():
    """While open, every ``Router`` of the program chooses as it would; yields
    the list of its choices, one for each router and input (a recomputation
    adds none), in the order made: the ``picks`` of ``replayed``."""
    picks, seen, forward = [], set(), dv.Router.forward

    def record(self, x):
        out = forward(self, x)
        if _key(self, x) not in seen:
            seen.add(_key(self, x))
            picks.append(out[0].detach())
        return out

    with mock.patch.object(dv.Router, "forward", record):
        yield picks


@contextlib.contextmanager
def replayed(picks):
    """While open, every ``Router`` of the program returns the next of
    ``picks`` (the same one again for a router and input it has seen: a
    recomputation), with the program's own weights of those experts. Yields
    the list of the program's own choices, filled as it runs. Every pick is
    to be taken by the time it closes."""
    picks, given, chosen, forward = list(picks), {}, [], dv.Router.forward

    def held(self, x):
        key = _key(self, x)
        if key not in given:
            with torch.no_grad():
                chosen.append(forward(self, x)[0])
            given[key] = picks.pop(0).to(x.device)
        idx = given[key]
        scores = torch.sigmoid(torch.nn.functional.linear(x.float(), self.weight.float()))
        weight = scores.gather(1, idx)
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
        return idx, weight * self.arch.routed_scaling_factor

    with mock.patch.object(dv.Router, "forward", held):
        yield chosen
    assert not picks, f"{len(picks)} choices left unused"


@contextlib.contextmanager
def held_to_reference(w, calls, cfg, hidden=None):
    """While open, every ``Router`` of the program returns the experts the
    reference (``tests/reference_deepseek_v3.py``, over ``w`` and ``cfg``;
    ``hidden``: another reference's forward that routes through its
    ``route``) chose for the same tokens, with the program's own weights of
    them (``replayed``). ``calls``: the ids of each of the program's model
    calls, in order. Yields the list of the program's own choices, filled
    as it runs."""
    picks, route = [], ref.route

    def record(*a):
        idx, weight = route(*a)
        picks.append(idx)
        return idx, weight

    with torch.no_grad(), mock.patch.object(ref, "route", record):
        for ids in calls:
            (hidden or ref.hidden)(w, ids, cfg)
    with replayed(picks) as chosen:
        yield chosen
