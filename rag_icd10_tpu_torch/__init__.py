"""rag_icd10_tpu_torch — the ICD-10 index-and-query engine on PyTorch/CUDA.

A port of the JAX package ``rag_icd10_tpu`` (which stays the reference)
to PyTorch on an NVIDIA H100. The layout mirrors the JAX package module
for module (config, data, models, ops, index, pipeline, api, runtime);
this package imports nothing of it and keeps its own copy of every host
module it needs.

Ported so far: the API server with every search method and residency of
the JAX store (exact, approx, fast, streaming, chunkstream, int8, host +
sketch, hnsw, remote), corpus-sharded search over a device mesh
(``parallel/``, NCCL or gloo across processes), NER model mode, the
fused query engine, weight conversion, the store builder
(``tools/build_database.py``), encoder training, data parallel and
Megatron tensor parallel (``parallel/tensor_parallel.py``), with the
retrieval eval and its gate, and NER training (``tools/train_ner.py``):
everything the JAX package does. Each TPU kernel is a hand-written CUDA
kernel under ``ops/csrc/``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
