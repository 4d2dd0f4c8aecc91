"""Contrastive encoder training: single-device, or data- and tensor-parallel
over a (dp, tp) mesh.

Counterpart of rag_icd10_tpu/parallel/train.py: in-batch-negatives
bidirectional InfoNCE (the sentence-transformers
MultipleNegativesRankingLoss objective) with duplicate-title masking,
hard negatives and the served level weights folded into the logits.

- The model trains with fp32 parameters and bf16 compute
  (``BertArch.param_dtype``), as flax keeps fp32 params under a bf16
  ``dtype``, and steps ``torch.optim.AdamW`` (betas 0.9/0.999, eps 1e-8,
  decoupled weight decay 0.01 on every parameter: ``optax.adamw`` applies
  no mask by default). The learning rate at update t is ``schedule(t)``
  through a ``LambdaLR`` stepped after the optimizer, so the first update
  runs at ``schedule(0)`` as optax's does.
- ``warmup_cosine_decay_schedule`` is optax's, step for step
  (``decay_steps`` includes the warmup).
- The data-parallel step (``make_sharded_train_step``) keeps the in-batch
  negatives global, as XLA does under pjit: each rank embeds its rows of
  the batch, gathers every rank's embeddings and puts its own tensor back
  in its place, so the loss is the loss over the whole batch and each
  rank's backward yields its rows' share of the gradient; one
  ``all_reduce`` sums the shares. The step's loss and update equal the
  single-device step over the whole batch. Ranks join through
  ``torch.distributed`` (parallel/multihost.py): gloo between CPU
  processes, NCCL between cards.
- With ``tp`` > 1 the model is ``TensorParallelBert``
  (parallel/tensor_parallel.py): Megatron tensor parallelism by the JAX
  package's rules, each tp shard's AdamW moments living with its
  parameters (``opt_state_shardings``). The dp exchanges (the embedding
  gather, the gradient ``all_reduce``) run over the dp group, the ranks
  that hold the same tp shards (parallel/mesh.py ``train_layout``).

- The arch's family (models/family.py) gives the model and the checkpoint
  layout of its parameters and optimizer leaves (``TrainState.family``).

The forward and backward are plain PyTorch autograd: no Pallas kernel of
the JAX package has a backward pass (XLA differentiates the model there).
Both steps are one body, which records the spans ``train.step.forward``
(to the device, embed, any dp gather, loss), ``train.step.backward`` (with
any dp all-reduce) and ``train.step.update`` (AdamW) in utils/metrics.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.optim.lr_scheduler import LambdaLR

from ..models.convert_hf import (
    adam_leaves,
    opt_state_from_leaves,
    opt_state_to_leaves,
    split_adam_leaves,
)
from ..models.family import BERT, Family, of_arch
from ..utils.device import resolve_device
from ..utils.metrics import metrics
from .mesh import Mesh, PartitionSpec, _spec_for_path, train_layout
from .tensor_parallel import TensorParallelBert, _flatten, _nest, _piece, split_dim

Schedule = Union[float, Callable[[int], float]]

MASK_VALUE = -1e9  # masked logits, after the temperature (not -inf: rows stay finite)


def contrastive_loss(za: torch.Tensor, zb: torch.Tensor, temperature: float = 0.05):
    """Bidirectional in-batch-negatives InfoNCE over L2-normalized
    embeddings. za/zb: (B, H), row i of za pairs with row i of zb.
    Returns (loss, accuracy) as 0-d tensors."""
    logits = (za @ zb.T) / temperature  # (B, B)
    labels = torch.arange(za.shape[0], device=za.device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
    accuracy = (logits.argmax(dim=1) == labels).float().mean()
    return loss, accuracy


def contrastive_loss_masked(
    za: torch.Tensor,
    zb: torch.Tensor,
    group_a: torch.Tensor,
    group_b: torch.Tensor,
    zh: Optional[torch.Tensor] = None,
    h_group: Optional[torch.Tensor] = None,
    temperature: float = 0.05,
    w_b: Optional[torch.Tensor] = None,
    w_h: Optional[torch.Tensor] = None,
):
    """InfoNCE with duplicate-collision masking and optional hard negatives
    (the JAX docstring, rag_icd10_tpu/parallel/train.py:52-87, gives the
    reasons).

    ``group_a``/``group_b`` are per-row integer title ids of the anchor and
    of the record behind the positive; off-diagonal logits where any of
    them collide are set to -1e9 after dividing by the temperature. ``zh``
    (B, H) are hard negatives that every anchor sees, their columns masked
    where ``h_group`` equals the anchor's or its positive's title id.
    ``w_b``/``w_h`` (B,) scale each comparison column by its served level
    weight (w·cos); the reverse direction uses the same weighted matrix
    transposed."""
    b = za.shape[0]
    logits_pos = za @ zb.T  # (B, B)
    if w_b is not None:
        logits_pos = logits_pos * w_b[None, :]
    logits_pos = logits_pos / temperature
    same = (
        (group_a[:, None] == group_a[None, :])
        | (group_b[:, None] == group_b[None, :])
        | (group_a[:, None] == group_b[None, :])
        | (group_b[:, None] == group_a[None, :])
    )
    off_diag = ~torch.eye(b, dtype=torch.bool, device=za.device)
    logits_pos = logits_pos.masked_fill(same & off_diag, MASK_VALUE)
    labels = torch.arange(b, device=za.device)
    if zh is not None:
        logits_hn = za @ zh.T  # (B, B)
        if w_h is not None:
            logits_hn = logits_hn * w_h[None, :]
        logits_hn = logits_hn / temperature
        false_neg = (h_group[None, :] == group_a[:, None]) | (
            h_group[None, :] == group_b[:, None]
        )
        logits_hn = logits_hn.masked_fill(false_neg, MASK_VALUE)
        logits_fwd = torch.cat([logits_pos, logits_hn], dim=1)  # (B, 2B)
    else:
        logits_fwd = logits_pos
    loss = 0.5 * (F.cross_entropy(logits_fwd, labels) + F.cross_entropy(logits_pos.T, labels))
    accuracy = (logits_fwd.argmax(dim=1) == labels).float().mean()
    return loss, accuracy


# ------------------------------------------------------------- optimizer


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` until ``decay_steps`` (which includes the
    warmup), computed in fp32 as optax computes it."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={decay_steps - warmup_steps}."
        )
    f32 = np.float32
    alpha = f32(0.0 if peak_value == 0.0 else end_value / peak_value)
    cosine_steps = f32(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float((f32(init_value) - f32(peak_value)) * frac + f32(peak_value))
        t = min(f32(count - warmup_steps), cosine_steps)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / cosine_steps, dtype=f32))
        return float(f32(peak_value) * ((f32(1) - alpha) * cosine + alpha))

    return schedule


def make_optimizer(model: torch.nn.Module, schedule: Schedule, weight_decay: float = 0.01):
    """``optax.adamw(schedule, weight_decay)`` as ``torch.optim.AdamW`` over
    every parameter and a ``LambdaLR`` giving the learning rate
    ``schedule(t)`` at update t (a float is a constant schedule)."""
    fn = schedule if callable(schedule) else (lambda t, lr=float(schedule): lr)
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )
    return optimizer, LambdaLR(optimizer, fn)


@dataclasses.dataclass
class TrainState:
    """What the JAX step threads through as (params, opt_state): the model
    with its fp32 parameters, its AdamW and the learning-rate schedule."""

    model: torch.nn.Module
    optimizer: torch.optim.AdamW
    scheduler: LambdaLR
    family: Family = BERT  # the checkpoint's layout of the params and optimizer leaves

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def step(self) -> int:
        """Updates applied so far (optax's count)."""
        return self.scheduler.last_epoch

    @property
    def num_leaves(self) -> int:
        """Leaves of the JAX-layout parameter tree."""
        return len(list(self.model.parameters()))

    def params(self) -> Dict:
        """The parameters as fp32 numpy arrays in the family's layout: BERT's
        JAX-layout tree (``save_params``, ``TextEncoder(params=...)``)."""
        return self.family.params_of(self.model)

    def opt_state_leaves(self) -> List[np.ndarray]:
        """The optimizer state as the leaves of ``optax.adamw(schedule)``
        (the ``leaf_i`` of ``opt_state.npz``)."""
        return opt_state_to_leaves(self.optimizer, self.model, self.family.leaf_order(self.model))

    def load_opt_state(self, leaves) -> None:
        """Adopt optax-layout optimizer leaves: the moments, the Adam count
        and the schedule's position."""
        sd = self.optimizer.state_dict()
        sd["state"] = opt_state_from_leaves(leaves, self.model, self.family.leaf_order(self.model))
        self.optimizer.load_state_dict(sd)
        self._resume_schedule(leaves)

    def _resume_schedule(self, leaves) -> None:
        count = int(np.asarray(leaves[0]))  # optax's schedule count equals it
        self.scheduler = LambdaLR(self.optimizer, self.scheduler.lr_lambdas[0],
                                  last_epoch=count - 1)


def opt_state_shardings(mesh: Optional[Mesh], params: Dict, opt_state) -> List[PartitionSpec]:
    """The ``PartitionSpec`` of each leaf of an ``optax.adamw`` state over
    ``params`` (a JAX-layout tree; only its paths matter), as the JAX
    package's ``opt_state_shardings`` gives them: Adam's ``mu`` and ``nu``
    mirror the parameter tree and take each parameter's spec, the counts
    replicate. Replicating the moments (twice the parameters' bytes) would
    cancel TP's memory saving. ``opt_state`` is the list of leaves."""
    paths = sorted(_flatten(params), key=lambda path: path.split("/"))
    split_adam_leaves(opt_state, len(paths))
    specs = [_spec_for_path(path) for path in paths]
    return [()] + specs + specs + [()] * (len(opt_state) - 1 - 2 * len(paths))


class TensorParallelTrainState(TrainState):
    """A ``TrainState`` over a ``TensorParallelBert``: AdamW steps this
    rank's shards, whose moments live with them. ``params`` and
    ``opt_state_leaves`` gather the full tree and the full optax leaves,
    a collective over the tp group: every tp rank calls them."""

    @property
    def num_leaves(self) -> int:
        return len(self.model.shapes)

    def params(self) -> Dict:
        return self.model.gather(lambda p: p)

    def opt_state_leaves(self) -> List[np.ndarray]:
        state = self.optimizer.state
        count = next((int(float(s["step"])) for s in state.values() if "step" in s), 0)
        moments = []
        for key in ("exp_avg", "exp_avg_sq"):
            tree = _flatten(self.model.gather(
                lambda p, key=key: state[p][key] if key in state.get(p, {})
                else torch.zeros_like(p)))
            moments.append([tree[path] for path in self.model.shapes])
        return adam_leaves(count, *moments)

    def load_opt_state(self, leaves) -> None:
        """Split optax-layout leaves by ``opt_state_shardings``: each shard
        takes its piece of every moment."""
        paths = list(self.model.shapes)
        specs = opt_state_shardings(None, _nest(self.model.shapes), leaves)
        count, _, _ = split_adam_leaves(leaves, len(paths))
        step = torch.tensor(float(count), dtype=torch.float32)
        column = {path: j for j, path in enumerate(paths)}
        n_tp = self.model.n_tp
        state = {}
        for i, (p, path, t) in enumerate(self.model.pieces()):
            moments = []
            for j in (1 + column[path], 1 + len(paths) + column[path]):
                x = _piece(np.asarray(leaves[j], np.float32), split_dim(specs[j]), n_tp, t or 0)
                moments.append(torch.from_numpy(np.array(x)).to(p.device))
            state[i] = {"step": step.clone(), "exp_avg": moments[0], "exp_avg_sq": moments[1]}
        sd = self.optimizer.state_dict()
        sd["state"] = state
        self.optimizer.load_state_dict(sd)
        self._resume_schedule(leaves)


def init_train_state(
    arch,
    mesh: Optional[Mesh] = None,
    learning_rate: float = 2e-5,
    seed: int = 0,
    schedule: Optional[Schedule] = None,
    params: Optional[Dict] = None,
    opt_state=None,
    device: Union[str, torch.device] = "cuda",
) -> TrainState:
    """A ``TrainState`` on ``device``, or with a mesh on this rank's
    device (``train_layout``): over a ``TensorParallelBert`` holding this
    rank's tp shards where the mesh's tp > 1 (a
    ``TensorParallelTrainState``). ``schedule`` (a callable t -> lr, or a
    float) replaces the constant ``learning_rate``. ``params`` (in the
    family's layout) and ``opt_state`` (optax leaves) start from an
    existing state instead of a seeded init: a warm start or resume must
    survive the dp and tp paths, whose ranks all start from the same host
    values. A dimension that tp splits but does not divide raises
    ``ValueError``.

    The arch's family (models/family.py) gives the seeded init and the
    model; one that trains on one device refuses a mesh (``ValueError``)."""
    family = of_arch(arch)
    if mesh is not None and not family.mesh:
        raise ValueError(f"{family.model_type} trains on one device: no dp/tp mesh")
    layout = train_layout(mesh) if mesh is not None else None
    if params is None:
        params = family.init_params(arch, seed=seed)
    if layout is not None and layout.n_tp > 1:
        master = dataclasses.replace(arch, param_dtype=torch.float32)
        model, kind = TensorParallelBert(master, layout), TensorParallelTrainState
        model.load_params(params)
    else:
        with torch.device(layout.device if layout is not None else resolve_device(device)):
            model, kind = family.module(arch), TrainState
        model.load_state_dict(family.state_dict(params))
    model.train()
    optimizer, scheduler = make_optimizer(model, learning_rate if schedule is None else schedule)
    state = kind(model, optimizer, scheduler, family)
    if opt_state is not None:
        state.load_opt_state(opt_state)
    return state


# ------------------------------------------------------------------ steps


_INT_KEYS = ("_ids", "_mask", "_types", "group_a", "group_b", "h_group")


def _to_device(batch: Dict, device: torch.device, rows: Optional[slice] = None) -> Dict:
    """The batch as tensors on ``device``; ``rows`` keeps those rows of the
    token arrays only: title ids and level weights index the loss's
    columns, which span the whole batch."""
    out = {}
    for key, value in batch.items():
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
        if rows is not None and not key.startswith(("group_", "h_group", "w_")):
            t = t[rows]
        integer = key.endswith(_INT_KEYS)
        out[key] = t.to(device, torch.long if integer else torch.float32)
    return out


def _check_batch(batch: Dict) -> None:
    if "h_ids" in batch and "group_a" not in batch:
        raise ValueError(
            "hard-negative batches require group_a/group_b/h_group "
            "(plain InfoNCE would silently ignore the hard negatives)"
        )
    if "h_ids" in batch and "h_group" not in batch:
        raise ValueError("h_ids given without h_group title ids")


def _embed(model: torch.nn.Module, batch: Dict):
    """(za, zb, zh) of a batch's rows; anchors and hard negatives share one
    stacked forward (same sequence length, twice the rows)."""
    if "h_ids" in batch:
        b = batch["a_ids"].shape[0]
        zah = model(*(torch.cat([batch[f"a_{k}"], batch[f"h_{k}"]]) for k in ("ids", "mask", "types")))
        za, zh = zah[:b], zah[b:]
    else:
        za, zh = model(batch["a_ids"], batch["a_mask"], batch["a_types"]), None
    zb = model(batch["b_ids"], batch["b_mask"], batch["b_types"])
    return za, zb, zh


def _gather_rows(x: torch.Tensor, group, rank: int, world: int) -> torch.Tensor:
    """Every rank's rows of ``x`` in rank order, with this rank's own tensor
    (and so its autograd graph) in its place."""
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    parts[rank] = x
    return torch.cat(parts)


def _loss(batch: Dict, za, zb, zh, temperature: float):
    if "group_a" in batch:
        return contrastive_loss_masked(
            za, zb, batch["group_a"], batch["group_b"], zh, batch.get("h_group"),
            temperature, w_b=batch.get("w_b"), w_h=batch.get("w_h"),
        )
    return contrastive_loss(za, zb, temperature)


def apply_update(state: TrainState) -> None:
    """One AdamW update from the gradients in place, then the schedule's
    next learning rate."""
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.scheduler.step()


def make_train_step(temperature: float = 0.05):
    """Returns train_step(state, batch) -> metrics: one AdamW update of
    ``state`` in place. ``batch`` holds numpy arrays or tensors; its keys
    decide the objective (JAX ``make_train_step``):

    - a_*/b_* only               -> plain bidirectional InfoNCE
    - + "group_a"/"group_b"      -> duplicate-title masking
    - + h_*/"h_group"            -> masked InfoNCE with hard negatives
    - + "w_b"/"w_h"              -> served level weights in the logits

    metrics: {"loss", "accuracy"} as 0-d tensors on the state's device."""
    return _step(temperature)


def _step(temperature: float, rows=None, gather=None, all_reduce=None):
    """The one step body; the sharded step gives the dp exchanges: ``rows``
    (batch -> this rank's rows), ``gather`` (its z -> every rank's) and
    ``all_reduce`` (sums the model's gradients)."""

    def train_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        _check_batch(batch)
        mine = rows(batch) if rows is not None else None
        with metrics.span("train.step.forward"):
            b = _to_device(batch, state.device, mine)
            z = _embed(state.model, b)
            if gather is not None:
                z = gather(*z)
            loss, acc = _loss(b, *z, temperature)
        with metrics.span("train.step.backward"):
            loss.backward()
            if all_reduce is not None:
                all_reduce(state.model)
        with metrics.span("train.step.update"):
            apply_update(state)
        return {"loss": loss.detach(), "accuracy": acc}

    return train_step


def make_sharded_train_step(mesh: Mesh, temperature: float = 0.05):
    """The step over a (dp, tp) mesh, for a state from
    ``init_train_state(mesh=mesh)``. Every rank calls it with the same
    whole batch (as every JAX process holds the global arrays) and embeds
    only its dp rows, through its tp shards where tp > 1; the loss runs
    over the whole batch's embeddings (in-batch negatives stay global),
    and the gradient shares are summed over the dp group, so loss and
    update equal ``make_train_step``'s over the whole batch.

    The replicated parameters' gradients need no sum over tp: each tp rank
    computes them from the same values (parallel/tensor_parallel.py)."""
    layout = train_layout(mesh)
    mine, n_dp, group = layout.dp_indices, layout.n_dp, layout.dp_group

    def rows(batch: Dict) -> slice:
        n = batch["a_ids"].shape[0]
        if n % n_dp:
            raise ValueError(f"batch of {n} rows does not split over dp={n_dp}")
        per = n // n_dp
        return slice(mine[0] * per, (mine[-1] + 1) * per)

    if group is None:
        return _step(temperature, rows)
    world, rank = dist.get_world_size(group), dist.get_rank(group)

    def gather(*z):
        return [None if x is None else _gather_rows(x, group, rank, world) for x in z]

    def all_reduce(model: torch.nn.Module) -> None:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    return _step(temperature, rows, gather, all_reduce)


# ---------------------------------------------------------------- batches


def make_triplet_batch(
    tokenizer,
    texts_a,
    texts_b,
    texts_h,
    group_a,
    group_b,
    h_group,
    seq_a: int = 48,
    seq_b: int = 96,
    pad_rows: Optional[int] = None,
    w_b=None,
    w_h=None,
) -> Dict[str, np.ndarray]:
    """Tokenize an (anchor, positive, hard-negative) batch with title-group
    ids into static-shape numpy arrays for the masked-loss step. Anchors
    and hard negatives are short titles (``seq_a``); positives are
    semantic texts with their own longer bucket (``seq_b``). ``w_b``/``w_h``
    carry the served level weight of each positive's record and each
    hard-negative title; padding rows get weight 1.0."""
    a_ids, a_mask, a_types = tokenizer.encode_batch(
        texts_a, max_length=seq_a, buckets=(seq_a,), pad_batch_to=pad_rows
    )
    b_ids, b_mask, b_types = tokenizer.encode_batch(
        texts_b, max_length=seq_b, buckets=(seq_b,), pad_batch_to=pad_rows
    )
    h_ids, h_mask, h_types = tokenizer.encode_batch(
        texts_h, max_length=seq_a, buckets=(seq_a,), pad_batch_to=pad_rows
    )
    out = {
        "a_ids": a_ids, "a_mask": a_mask, "a_types": a_types,
        "b_ids": b_ids, "b_mask": b_mask, "b_types": b_types,
        "h_ids": h_ids, "h_mask": h_mask, "h_types": h_types,
        "group_a": np.asarray(group_a, np.int32),
        "group_b": np.asarray(group_b, np.int32),
        "h_group": np.asarray(h_group, np.int32),
    }
    if w_b is not None:
        rows = a_ids.shape[0]
        wb = np.ones(rows, np.float32)
        wb[: len(w_b)] = np.asarray(w_b, np.float32)
        wh = np.ones(rows, np.float32)
        if w_h is not None:
            wh[: len(w_h)] = np.asarray(w_h, np.float32)
        out["w_b"], out["w_h"] = wb, wh
    return out


def make_pair_batch(
    tokenizer, texts_a, texts_b, max_length: int = 64, pad_rows: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Tokenize a pair batch into static-shape numpy arrays."""
    a_ids, a_mask, a_types = tokenizer.encode_batch(
        texts_a, max_length=max_length, buckets=(max_length,), pad_batch_to=pad_rows
    )
    b_ids, b_mask, b_types = tokenizer.encode_batch(
        texts_b, max_length=max_length, buckets=(max_length,), pad_batch_to=pad_rows
    )
    return {
        "a_ids": a_ids, "a_mask": a_mask, "a_types": a_types,
        "b_ids": b_ids, "b_mask": b_mask, "b_types": b_types,
    }
