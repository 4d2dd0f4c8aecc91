"""Fail-fast guard for acquiring the CUDA device.

Counterpart of rag_icd10_tpu/utils/device_guard.py. A wedged or lost
card, or a CUDA stack that never answers, can block the first CUDA touch
(``torch.cuda.init()``, context creation, the first allocation) inside
CUDA's C++ code, where no Python signal reaches it: an entry point
without a ``timeout`` (server startup, store build, training) then hangs
with no log output.

``guard_device_acquisition`` arms a daemon watchdog before the first CUDA
touch; ``acquire_device`` disarms it once ``torch.cuda.init()`` and one
small allocation on the device have returned. On expiry the watchdog
prints a one-line JSON diagnostic to stderr and hard-exits with code 2
(``os._exit``: the blocked thread cannot be joined), so a supervising
script sees "device unavailable" instead of a silent hang.

The reference treats startup failures as degradable (main.py:53-89
continues with a broken Milvus/LLM), but here the card is the system:
there is nothing to degrade to, so the honest behavior is a fast,
diagnosable exit. A caller that asks for the CPU arms no guard.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Callable, Optional, Union

import torch

from .device import resolve_device

DEFAULT_TIMEOUT_S = 600.0
_ENV = "DEVICE_ACQUIRE_TIMEOUT_S"


def guard_device_acquisition(
    timeout_s: Optional[float] = None,
    *,
    what: str = "CUDA device init",
    on_timeout: Optional[Callable[[], None]] = None,
) -> Callable[[], None]:
    """Arm a watchdog around device acquisition; returns the disarm fn.

    ``timeout_s`` defaults to $DEVICE_ACQUIRE_TIMEOUT_S or 600 s; a value
    <= 0 disables the guard (returns a no-op disarm). ``on_timeout``
    replaces the default print + os._exit(2); tests inject a recorder
    here, since os._exit cannot run under pytest.
    """
    if timeout_s is None:
        timeout_s = float(os.environ.get(_ENV, DEFAULT_TIMEOUT_S))
    acquired = threading.Event()
    if timeout_s <= 0:
        return acquired.set

    def _default_timeout() -> None:
        print(
            json.dumps({
                "error": "device acquisition timed out",
                "what": what,
                "timeout_s": timeout_s,
                "hint": "torch.cuda.init() or the first allocation on the card "
                "never returned: the card or its CUDA stack is unresponsive "
                "(check nvidia-smi); retry once it answers "
                f"(raise {_ENV} to wait longer)",
            }),
            file=sys.stderr,
            flush=True,
        )
        os._exit(2)

    handler = on_timeout or _default_timeout

    def _watch() -> None:
        if not acquired.wait(timeout_s):
            handler()

    threading.Thread(
        target=_watch, name=f"device-guard[{what}]", daemon=True
    ).start()
    return acquired.set


def acquire_device(device: Union[str, torch.device] = "cuda", *, what: str) -> torch.device:
    """``resolve_device(device)``; for a CUDA device, under the guard,
    with ``torch.cuda.init()`` and one small allocation on it before the
    guard is disarmed. A CPU device arms no guard."""
    if torch.device(device).type != "cuda":
        return resolve_device(device)
    disarm = guard_device_acquisition(what=what)
    try:
        dev = resolve_device(device)
        torch.cuda.init()
        torch.empty(1, device=dev)
    finally:
        disarm()
    return dev
