"""Corpus-sharded search over a device mesh (counterpart of
rag_icd10_tpu/parallel/). The training exports of the JAX package
(``contrastive_train_step``, ``init_train_state``) come with the port of
its training step."""

from .mesh import Mesh, make_mesh
from .search import ShardedFlatSearcher

__all__ = ["Mesh", "make_mesh", "ShardedFlatSearcher"]
