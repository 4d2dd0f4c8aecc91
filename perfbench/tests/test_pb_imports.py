"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole), and the reference loads nothing of the program."""

import subprocess
import sys

from perfbench.tests.pb_tiny import ROOT

PROBE = r"""
import sys, importlib, pkgutil
import perfbench, perfbench.readers, perfbench.drivers, perfbench.reference, perfbench.families
for pkg in (perfbench, perfbench.readers, perfbench.drivers, perfbench.reference,
            perfbench.families):
    for m in pkgutil.iter_modules(pkg.__path__):
        if m.name not in ("tests",):
            importlib.import_module(f"{pkg.__name__}.{m.name}")
import rag_icd10_tpu_torch.tools.train_encoder, rag_icd10_tpu_torch.parallel.train
from perfbench.bench import forbidden_modules
print("BAD", forbidden_modules())
"""

REF = r"""
import sys
import perfbench.reference.bert, perfbench.reference.draw, perfbench.reference.train
import perfbench.reference.tokenizer, perfbench.reference.lowp
print("PROG", sorted(m for m in sys.modules if m.split(".")[0] == "rag_icd10_tpu_torch"))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_no_jax_reachable_from_the_harness():
    assert "BAD []" in _run(PROBE)


def test_reference_loads_nothing_of_the_program():
    assert "PROG []" in _run(REF)


def test_prefix_is_not_the_package():
    from perfbench.bench import FORBIDDEN
    names = {"rag_icd10_tpu_torch", "jaxtyping", "flaxen"}
    assert not names & set(FORBIDDEN)
    assert {"rag_icd10_tpu", "jax"} <= set(FORBIDDEN)
