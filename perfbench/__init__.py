"""Benchmark of the PyTorch/CUDA port (``rag_icd10_tpu_torch``) on NVIDIA GPUs.

Run one cell from the repository root::

    python3 -m perfbench.run --workload text2vec-finetune.b256 \
        --seed 7 --seconds 10 --trace 0

``BENCHMARK.json`` at the repository root names the cells; everything one
configuration, traffic mix or per-layer metric needs sits in a file of its
own under ``configs/`` (with the source's values under ``published/``),
``traffic/``, ``metrics/`` (with its reader under ``readers/``) and
``limits/``, found by the name in ``BENCHMARK.json``; what is specific to a
model sits in ``families/<model_type>.py``, found by the configuration's
``model_type``.
``reference/`` holds the plain PyTorch reference that decides ``correct``;
it imports nothing of the program. Nothing here imports JAX or the JAX
package ``rag_icd10_tpu``.
"""
