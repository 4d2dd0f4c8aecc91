"""Corpus-sharded search over a device mesh, and data- and
tensor-parallel encoder training (counterpart of rag_icd10_tpu/parallel/)."""

from .mesh import Mesh, batch_sharding, make_mesh, param_shardings, train_layout
from .search import ShardedFlatSearcher
from .tensor_parallel import TensorParallelBert
from .train import (
    init_train_state,
    make_sharded_train_step,
    opt_state_shardings,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "param_shardings",
    "batch_sharding",
    "train_layout",
    "ShardedFlatSearcher",
    "TensorParallelBert",
    "init_train_state",
    "make_sharded_train_step",
    "opt_state_shardings",
]
