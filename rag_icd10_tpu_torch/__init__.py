"""rag_icd10_tpu_torch — the ICD-10 index-and-query engine on PyTorch/CUDA.

A port of the JAX package ``rag_icd10_tpu`` (which stays the reference)
to PyTorch on an NVIDIA H100. The layout mirrors the JAX package module
for module (config, data, models, ops, index, pipeline, api, runtime);
this package imports nothing of it and keeps its own copy of every host
module it needs.

Ported so far: the ``/query`` main path with the shipped defaults — host
extraction, the BERT sentence encoder, the flat ``exact``/``approx``
search over an fp32 or bf16 device-resident corpus, rescoring and the
API server. The TPU scoring kernel is a hand-written CUDA kernel
(``ops/csrc/fused_score.cu``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``. What is not yet ported raises
"not yet ported" (see ROADMAP.md).
"""

__version__ = "0.1.0"
