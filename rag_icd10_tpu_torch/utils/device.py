"""Device selection for the port's entry points.

Every entry point (TextEncoder, VectorStore, Engine, APIServer) runs on
``cuda`` unless the caller passes ``device="cpu"``. Asking for ``cuda``
where there is no card raises; nothing falls back to the CPU on its own.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: rag_icd10_tpu_torch runs on cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
