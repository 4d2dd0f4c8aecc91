"""Plain PyTorch reference of what the benchmark's cells compute.

Imports neither JAX, the JAX package, nor anything of
``rag_icd10_tpu_torch``: it works everything out again from the inputs the
benchmark made (weights, table, vocabulary), and reads the program's
outputs only to judge them. Where it follows the training window from the
program's own state (its parameters and AdamW moments), the start is
checked from the benchmark's weights on its own.
"""
