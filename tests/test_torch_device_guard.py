"""The port's device-acquisition guard (rag_icd10_tpu_torch/utils/device_guard.py).

The cases of tests/test_device_guard.py against the port's guard, the
default handler's exit in a child process, and the entry points: each
arms the guard around its first CUDA touch and none arms it for the CPU.
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from rag_icd10_tpu_torch.tools import train_ner
from rag_icd10_tpu_torch.utils import acquire_device, device_guard, guard_device_acquisition

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("how", ["argument", "env_default"])
def test_fires_when_never_disarmed(how, monkeypatch):
    fired = threading.Event()
    if how == "argument":
        guard_device_acquisition(0.05, on_timeout=fired.set)
    else:
        monkeypatch.setenv("DEVICE_ACQUIRE_TIMEOUT_S", "0.05")
        guard_device_acquisition(on_timeout=fired.set)
    assert fired.wait(2.0)


@pytest.mark.parametrize("how", ["disarmed", "nonpositive_timeout"])
def test_stays_quiet(how):
    fired = threading.Event()
    if how == "disarmed":
        disarm = guard_device_acquisition(0.2, on_timeout=fired.set)
        disarm()
        assert not fired.wait(0.5)
    else:
        disarm = guard_device_acquisition(0, on_timeout=fired.set)
        assert not fired.wait(0.3)
        disarm()  # no-op, must not raise


def test_late_disarm_after_fire_is_safe():
    fired = threading.Event()
    disarm = guard_device_acquisition(0.05, on_timeout=fired.set)
    assert fired.wait(2.0)
    disarm()  # must not raise even after the handler ran


def test_default_handler_prints_one_json_line_and_exits_2():
    script = ("import time\n"
              "from rag_icd10_tpu_torch.utils import guard_device_acquisition\n"
              "guard_device_acquisition(0.05, what='unit test')\n"
              "time.sleep(30)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2, out.stderr
    diag = json.loads(out.stderr.strip().splitlines()[-1])
    assert diag["error"] == "device acquisition timed out"
    assert diag["what"] == "unit test" and diag["timeout_s"] == 0.05
    assert "torch.cuda.init()" in diag["hint"] and "DEVICE_ACQUIRE_TIMEOUT_S" in diag["hint"]


@pytest.fixture
def armed(monkeypatch):
    """Records every arming and disarming of the guard."""
    log = []

    def guard(timeout_s=None, *, what="", on_timeout=None):
        log.append(("arm", what))
        return lambda: log.append(("disarm", what))

    monkeypatch.setattr(device_guard, "guard_device_acquisition", guard)
    return log


def test_cpu_arms_no_guard(armed):
    assert acquire_device("cpu", what="x") == torch.device("cpu")
    assert armed == []


def test_cuda_is_acquired_under_the_guard(armed):
    if torch.cuda.is_available():
        assert acquire_device("cuda", what="x").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            acquire_device("cuda", what="x")
    assert armed == [("arm", "x"), ("disarm", "x")]


def test_train_ner_on_the_cpu_arms_no_guard(armed, tmp_path, monkeypatch):
    monkeypatch.setenv("ICD_DATA_PATH", str(tmp_path / "absent.csv"))  # synthetic fallback
    monkeypatch.setenv("NER_WEIGHTS_PATH", "")
    assert train_ner.main(["--eval-only", "--out", str(tmp_path / "none")], device="cpu") == 1
    assert armed == []


@pytest.mark.parametrize("entry,what", [
    ("build_database", "database build"),
    ("train_encoder", "encoder training"),
    ("train_ner", "NER training"),
    ("app", "serving startup"),
])
def test_entry_points_acquire_the_card_under_the_guard(entry, what, armed, tmp_path):
    """Each CLI arms the guard before its first CUDA touch, where the JAX
    package arms its own, and disarms it when acquisition fails."""
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the entry point would run")
    from rag_icd10_tpu_torch.api import app
    from rag_icd10_tpu_torch.tools import build_database, train_encoder

    run = {"build_database": lambda: build_database.main(["--verify-only"]),
           "train_encoder": lambda: train_encoder.main(["--out", str(tmp_path / "t")]),
           "train_ner": lambda: train_ner.main(["--out", str(tmp_path / "n")]),
           "app": app.main}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()
    assert armed == [("arm", what), ("disarm", what)]
