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


def is_device_error(exc: BaseException) -> bool:
    """True for a failure of the card or the CUDA runtime: a refused or
    failed kernel launch, a device-side assert, device memory exhausted,
    or ``cuda`` asked for with no card. Such an error raises where the JAX
    package would degrade (NER model mode to rules, a scoring helper to
    its default): serving on regardless would hide a broken device."""
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(exc, accelerator_error):
        return True
    return isinstance(exc, RuntimeError) and "cuda" in str(exc).lower()


def reraise_device_error(exc: BaseException) -> None:
    """Raise ``exc`` again if it is a device error: for the handlers that
    degrade a scoring or extraction step on any other failure."""
    if is_device_error(exc):
        raise exc
