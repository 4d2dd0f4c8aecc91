"""The port imports neither JAX nor anything of the JAX package.

Every module of rag_icd10_tpu_torch is imported in a fresh interpreter in
which ``import jax`` and ``import flax`` fail; afterwards no module of
rag_icd10_tpu may be loaded.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import rag_icd10_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "rag_icd10_tpu" or m.startswith("rag_icd10_tpu."))
print("modules=%d" % len(names))
print("names=" + ",".join(names))
print("leaked=" + ",".join(leaked))
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    report = dict(line.split("=", 1) for line in out.stdout.split())
    assert int(report["modules"]) >= 58, out.stdout  # every module was walked
    walked = set(report["names"].split(","))
    for name in ("ops.rerank", "ops.quantized", "ops.sketch", "index.hnsw_index",
                 "index.remote_store", "pipeline.ner_model", "ops.fused_query",
                 "tools.convert_weights", "client", "ui_app", "parallel",
                 "parallel.mesh", "parallel.multihost", "parallel.search",
                 "data.augment", "tools.build_database", "parallel.train", "eval",
                 "eval.retrieval", "tools.eval_retrieval", "tools.train_encoder"):
        assert "rag_icd10_tpu_torch." + name in walked, name
    assert report["leaked"] == "", f"JAX package modules imported: {report['leaked']}"


def test_source_names_no_jax_import():
    """No module of the port spells an import of jax, flax or the JAX
    package, even inside a function that the import test cannot reach."""
    bad = []
    for path in (ROOT / "rag_icd10_tpu_torch").rglob("*.py"):
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            s = line.strip()
            if s.startswith(("import ", "from ")) and any(
                s.split()[1] == m or s.split()[1].startswith(m + ".")
                for m in ("jax", "flax", "rag_icd10_tpu")
            ):
                bad.append(f"{path.relative_to(ROOT)}:{lineno}: {s}")
    assert not bad, "\n".join(bad)
