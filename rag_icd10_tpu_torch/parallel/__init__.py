"""Corpus-sharded search over a device mesh and data-parallel encoder
training (counterpart of rag_icd10_tpu/parallel/)."""

from .mesh import Mesh, batch_sharding, make_mesh, param_shardings
from .search import ShardedFlatSearcher
from .train import contrastive_train_step, init_train_state

__all__ = [
    "Mesh",
    "make_mesh",
    "param_shardings",
    "batch_sharding",
    "ShardedFlatSearcher",
    "contrastive_train_step",
    "init_train_state",
]
