"""Megatron tensor parallelism of the sentence encoder's training step.

The JAX package writes no TP code: it annotates the parameter tree with
the Megatron rules (rag_icd10_tpu/parallel/mesh.py:49-73) and XLA derives
the split computation and its collectives (parallel/train.py:1-13). This
module is what XLA derives, spelled out for PyTorch, with the forward
arithmetic of ``models/bert.py``:

- **Column-parallel Dense** (``attention/{query,key,value}``,
  ``intermediate``; kernel ``(None, "tp")``, bias ``("tp",)``): each
  shard holds its own output columns and computes them.
- **Row-parallel Dense** (``attention/out``, ``output``; kernel
  ``("tp", None)``): each shard multiplies its input columns by its rows;
  the partial products are summed and the replicated bias is added once,
  after the sum.
- **Vocab-parallel embedding** (``word_embeddings``, ``("tp", None)``):
  each shard looks up the ids in its row range and gives zero vectors
  elsewhere; the shards' vectors are summed. An id outside the vocabulary
  raises ``IndexError``, as ``nn.Embedding`` does at tp = 1.
- **Attention**: where the heads divide over tp, each shard runs its own
  heads on its q, k, v columns. Where they do not (12 heads at tp = 8),
  q, k and v are gathered over tp, attention runs whole, and each shard
  takes its columns of the context for the row-parallel ``out``.

The shards of one rank (logical shards) are summed with plain tensor
sums, which autograd differentiates. Where the tp group has a process
group (parallel/mesh.py ``train_layout``; NCCL at world size 1 too), the
cross-rank reductions are three ``torch.autograd.Function``s: ``copy``
(identity forward, ``all_reduce`` backward) in front of the
column-parallel layers, ``reduce`` (``all_reduce`` forward, identity
backward) after the row-parallel layers and the embedding, and
``gather`` (``all_gather`` forward, reduce-scatter backward) for the
q/k/v gather.

Every reduction sums fp32: each shard's partial product is rounded to the
compute dtype by its GEMM, as the whole product is at tp = 1, and is
widened to fp32 before the sum. Parameters are fp32 master weights in the
JAX layout (kernels ``(in, out)``), so ``split_params``/``join_params``
carry them, and the optimizer's moments, to and from the JAX-layout tree
by ``param_shardings``.

Replicated parameters (the LayerNorms, the position and token-type
embeddings, the row-parallel biases) need no tp reduction: they act
after a reduction, on values every tp rank holds alike, so their
gradients come out the same on every tp rank.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.bert import BertArch, attention, attention_bias, mean_pool_normalize
from .mesh import PartitionSpec, TrainLayout, _spec_for_path


# ------------------------------------------------------------- the layout


def param_shapes(arch: BertArch) -> Dict[str, Tuple[int, ...]]:
    """Shape of every parameter of the JAX-layout encoder tree, keyed by
    its '/'-joined path, in ``jax.tree_util.tree_leaves`` order (keys
    sorted at every level)."""
    h, inter = arch.hidden_size, arch.intermediate_size
    shapes = {
        "bert/word_embeddings/embedding": (arch.vocab_size, h),
        "bert/position_embeddings/embedding": (arch.max_position_embeddings, h),
        "bert/token_type_embeddings/embedding": (arch.type_vocab_size, h),
        "bert/embeddings_ln/scale": (h,),
        "bert/embeddings_ln/bias": (h,),
    }
    for i in range(arch.num_layers):
        p = f"bert/layer_{i}"
        for name in ("query", "key", "value", "out"):
            shapes[f"{p}/attention/{name}/kernel"] = (h, h)
            shapes[f"{p}/attention/{name}/bias"] = (h,)
        shapes[f"{p}/intermediate/kernel"] = (h, inter)
        shapes[f"{p}/intermediate/bias"] = (inter,)
        shapes[f"{p}/output/kernel"] = (inter, h)
        shapes[f"{p}/output/bias"] = (h,)
        for ln in ("attention_ln", "output_ln"):
            shapes[f"{p}/{ln}/scale"] = (h,)
            shapes[f"{p}/{ln}/bias"] = (h,)
    return {path: shapes[path] for path in sorted(shapes, key=lambda x: x.split("/"))}


def split_dim(spec: PartitionSpec) -> Optional[int]:
    """The array axis a spec splits over tp, or None (replicated)."""
    return spec.index("tp") if "tp" in spec else None


def _check_splits(path: str, shape: Sequence[int], n_tp: int) -> Optional[int]:
    dim = split_dim(_spec_for_path(path))
    if dim is not None and shape[dim] % n_tp:
        raise ValueError(f"{path}: dimension {dim} of shape {tuple(shape)} does not split "
                         f"evenly over tp = {n_tp}")
    return dim


def piece_shape(shape: Sequence[int], dim: Optional[int], n_tp: int) -> Tuple[int, ...]:
    """The shape of one tp shard's piece of a leaf split on ``dim``."""
    return tuple(n // n_tp if i == dim else n for i, n in enumerate(shape))


def _piece(x, dim: Optional[int], n_tp: int, t: int):
    if dim is None:
        return x
    size = x.shape[dim] // n_tp
    index = [slice(None)] * x.ndim
    index[dim] = slice(t * size, (t + 1) * size)
    return x[tuple(index)]


def _flatten(tree, prefix: str = "") -> Dict[str, object]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_flatten(value, path) if isinstance(value, dict) else {path: value})
    return out


def _nest(flat: Dict[str, object]) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        keys = path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return tree


def split_params(tree: Dict, n_tp: int) -> List[Dict]:
    """A JAX-layout tree -> ``n_tp`` trees, shard t holding its piece of
    every leaf that ``param_shardings`` splits over tp (numpy views) and
    every replicated leaf whole. A split dimension that tp does not divide
    raises ``ValueError`` naming the parameter (``jax.device_put`` does)."""
    flat = _flatten(tree)
    dims = {path: _check_splits(path, np.shape(x), n_tp) for path, x in flat.items()}
    return [_nest({path: _piece(np.asarray(x), dims[path], n_tp, t)
                   for path, x in flat.items()}) for t in range(n_tp)]


def join_params(shards: Sequence[Dict]) -> Dict:
    """The inverse of ``split_params``: shard trees in tp order -> the
    JAX-layout tree (split leaves concatenated, replicated leaves taken
    from shard 0)."""
    flats = [_flatten(tree) for tree in shards]
    out = {}
    for path, x in flats[0].items():
        dim = split_dim(_spec_for_path(path))
        out[path] = x if dim is None else np.concatenate([f[path] for f in flats], axis=dim)
    return _nest(out)


# ------------------------------------------------------ the collectives


class _Copy(torch.autograd.Function):
    """Identity forward; backward sums the input's gradient over the tp
    group (fp32: the gradient of the fp32 hidden states). Without a group
    it is the identity both ways; it stays in the graph so that autograd
    sums the shards' gradients in the same order with a group and
    without, and a world-size-1 group gives the local step to the bit."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.group is not None:
            grad = grad.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """``all_reduce`` of the partial sums over the tp group forward (fp32);
    identity backward: every rank's partial gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """``all_gather`` of each rank's column block along the last axis
    forward. Backward is a reduce-scatter: each rank's gradient of the
    gathered tensor holds only its own share (what its columns of the
    context took from every head), so the shares are summed over the
    group (in fp32) and each rank keeps its block. It is spelled
    ``all_reduce`` + slice, which gloo runs too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank, world = dist.get_rank(group), dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        total = grad.float().contiguous()
        dist.all_reduce(total, group=ctx.group)
        width = grad.shape[-1] // dist.get_world_size(ctx.group)
        block = total[..., ctx.rank * width:(ctx.rank + 1) * width]
        return block.to(grad.dtype), None


# ----------------------------------------------------------- the model


class TensorParallelBert(nn.Module):
    """``SentenceBert`` split over a tp axis: this rank's shards
    (``layout.tp_indices``) of every split parameter, each an fp32 piece
    in the JAX layout, and the replicated parameters once, all on
    ``layout.device``. ``forward`` gives the L2-normalized sentence
    embeddings every tp rank holds alike.

    ``load_params`` and ``gather`` carry a JAX-layout tree in and out;
    ``arch.compute_dtype`` is the dtype of the dense products."""

    def __init__(self, arch: BertArch, layout: TrainLayout):
        super().__init__()
        self.arch, self.n_tp = arch, layout.n_tp
        self.tp_indices, self.group = layout.tp_indices, layout.tp_group
        self.shapes = param_shapes(arch)
        self.dims = {path: _check_splits(path, shape, self.n_tp)
                     for path, shape in self.shapes.items()}
        dev = layout.device

        def param(shape):
            return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=dev))

        self.replicated = nn.ParameterDict(
            {path: param(shape) for path, shape in self.shapes.items()
             if self.dims[path] is None})
        self.shards = nn.ModuleList(
            nn.ParameterDict({path: param(piece_shape(shape, self.dims[path], self.n_tp))
                              for path, shape in self.shapes.items()
                              if self.dims[path] is not None})
            for _ in self.tp_indices)
        # tp index of every parameter (None: replicated), by identity
        self._owner = {id(p): (path, None) for path, p in self.replicated.items()}
        for t, shard in zip(self.tp_indices, self.shards):
            self._owner.update({id(p): (path, t) for path, p in shard.items()})

    # -- carrying the JAX layout

    def pieces(self) -> List[Tuple[nn.Parameter, str, Optional[int]]]:
        """(parameter, JAX path, tp index or None) in ``parameters()`` order."""
        return [(p, *self._owner[id(p)]) for p in self.parameters()]

    def load_params(self, tree: Dict) -> None:
        """Copy this rank's pieces (``split_params``) of a JAX-layout tree:
        every rank holds the whole tree, as every JAX process holds the
        host values. ``ValueError`` where a leaf's shape is not the
        model's."""
        flat = _flatten(tree)
        for path, shape in self.shapes.items():
            if np.shape(flat[path]) != shape:
                raise ValueError(f"{path}: shape {np.shape(flat[path])}, the model's is {shape}")
        shards = [_flatten(x) for x in split_params(tree, self.n_tp)]
        with torch.no_grad():
            for p, path, t in self.pieces():
                p.copy_(torch.from_numpy(np.array(shards[t or 0][path], np.float32)))

    def gather(self, value: Callable[[nn.Parameter], torch.Tensor]) -> Dict:
        """The JAX-layout tree of fp32 numpy arrays whose leaves are
        ``value(parameter)`` joined over every tp shard (``join_params``):
        this rank's shards and, where the tp group has a process group,
        every other rank's, through one ``all_gather``. Every rank of the
        tp group must call it."""
        rep = {path: value(p).detach().float().cpu().numpy()
               for path, p in self.replicated.items()}
        split = [path for path in self.shapes if self.dims[path] is not None]
        pieces = [value(shard[path]).detach().float() for shard in self.shards for path in split]
        if self.group is not None:
            pieces = [x for rank in _all_gather_flat(pieces, self.group) for x in rank]
        return join_params([_nest({**rep, **{path: pieces[t * len(split) + i].cpu().numpy()
                                             for i, path in enumerate(split)}})
                            for t in range(self.n_tp)])

    # -- the forward

    def _reduce(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The sum over tp of the shards' partials, in fp32."""
        total = parts[0].float()
        for part in parts[1:]:
            total = total + part.float()
        return total if self.group is None else _Reduce.apply(total, self.group)

    def _column(self, x, path: str) -> List[torch.Tensor]:
        """Each shard's output columns of the Dense at ``path``."""
        dt = self.arch.compute_dtype
        return [F.linear(x.to(dt), s[f"{path}/kernel"].to(dt).T, s[f"{path}/bias"].to(dt))
                for s in self.shards]

    def _row(self, xs: List[torch.Tensor], path: str) -> torch.Tensor:
        """The row-parallel Dense at ``path`` over each shard's input
        columns: the partials summed, then the replicated bias, in fp32."""
        dt = self.arch.compute_dtype
        total = self._reduce([F.linear(x, s[f"{path}/kernel"].to(dt).T)
                              for x, s in zip(xs, self.shards)])
        return total + self.replicated[f"{path}/bias"].to(dt).float()

    def _layer_norm(self, x, path: str) -> torch.Tensor:
        r = self.replicated
        return F.layer_norm(x, (self.arch.hidden_size,), r[f"{path}/scale"], r[f"{path}/bias"],
                            self.arch.layer_norm_eps)

    def _embed_words(self, ids: torch.Tensor) -> torch.Tensor:
        v = self.arch.vocab_size
        lo, hi = (int(x) for x in torch.aminmax(ids))
        if lo < 0 or hi >= v:
            raise IndexError(f"token id {hi if hi >= v else lo} is out of range for a "
                             f"vocabulary of {v}")
        rows = v // self.n_tp
        parts = []
        for t, shard in zip(self.tp_indices, self.shards):
            local = ids - t * rows
            inside = (local >= 0) & (local < rows)
            emb = F.embedding(local.clamp(0, rows - 1), shard["bert/word_embeddings/embedding"])
            parts.append(emb * inside[..., None])
        return self._reduce(parts)

    def _attention(self, x, bias, path: str) -> List[torch.Tensor]:
        """Each shard's columns of the attention context."""
        a = self.arch
        head_dim = a.hidden_size // a.num_heads
        q, k, v = (self._column(x, f"{path}/{name}") for name in ("query", "key", "value"))
        if a.num_heads % self.n_tp == 0:
            return [attention(*qkv, bias, head_dim, a.compute_dtype) for qkv in zip(q, k, v)]
        whole = []
        for parts in (q, k, v):
            block = torch.cat(parts, dim=-1)
            whole.append(block if self.group is None else _Gather.apply(block, self.group))
        ctx = attention(*whole, bias, head_dim, a.compute_dtype)
        width = a.hidden_size // self.n_tp
        return [ctx[..., t * width:(t + 1) * width] for t in self.tp_indices]

    def forward(self, input_ids, attention_mask, token_type_ids) -> torch.Tensor:
        a, r = self.arch, self.replicated
        pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        hidden = self._layer_norm(
            self._embed_words(input_ids)
            + F.embedding(pos_ids, r["bert/position_embeddings/embedding"])
            + F.embedding(token_type_ids, r["bert/token_type_embeddings/embedding"]),
            "bert/embeddings_ln")
        bias = attention_bias(attention_mask)
        for i in range(a.num_layers):
            p = f"bert/layer_{i}"
            ctx = self._attention(_Copy.apply(hidden, self.group), bias, f"{p}/attention")
            hidden = self._layer_norm(hidden + self._row(ctx, f"{p}/attention/out"),
                                      f"{p}/attention_ln")
            inter = [F.gelu(x, approximate="none")
                     for x in self._column(_Copy.apply(hidden, self.group), f"{p}/intermediate")]
            hidden = self._layer_norm(hidden + self._row(inter, f"{p}/output"),
                                      f"{p}/output_ln")
        return mean_pool_normalize(hidden.float(), attention_mask)


def _all_gather_flat(blocks: List[torch.Tensor], group) -> List[List[torch.Tensor]]:
    """Every rank's ``blocks`` (the same shapes on every rank) in group
    rank order, through one ``all_gather`` of their concatenation (on the
    current card under NCCL, the CPU under gloo)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    flat = torch.cat([b.reshape(-1) for b in blocks]).to(dev)
    out = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, flat, group=group)
    sizes = [b.numel() for b in blocks]
    return [[x.view(b.shape) for x, b in zip(torch.split(buf, sizes), blocks)] for buf in out]

