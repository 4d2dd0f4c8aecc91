"""The store builder: the port's tools/build_database.py against the JAX
package's on one small synthetic corpus (300 CSV rows) with a small BERT
(2 layers, 64 hidden, fp32) whose weights are the JAX ``init_params``,
saved once and read by both packages (the port through ``load_params`` and
``params_from_jax``).

- Both builders write the same vocab file (the corpus plus
  ``augmentation_charset_texts``, the port's copy of data/augment.py)
  and the same metadata; the vectors agree within 2e-5 (fp32 BERT on the
  CPU in two frameworks, tests/test_torch_bert.py's tolerance).
- Each package's ``VectorStore.load`` reads the other's store, and both
  answer the verification query with the same hits.
- ``embed_sorted``: a device error raises, any other error zero-fills
  the batch and is counted.
"""

import csv
import dataclasses
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_icd10_tpu import config as jconfig
from rag_icd10_tpu.index.vector_store import VectorStore as JStore
from rag_icd10_tpu.models.bert import BertArch as JArch
from rag_icd10_tpu.models.bert import init_params as jinit
from rag_icd10_tpu.models.convert_hf import save_params
from rag_icd10_tpu.tools.build_database import DatabaseBuilder as JBuilder
from rag_icd10_tpu_torch import config as tconfig
from rag_icd10_tpu_torch.data import augment
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.index.vector_store import VectorStore
from rag_icd10_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_icd10_tpu_torch.tools import build_database
from rag_icd10_tpu_torch.tools.build_database import DatabaseBuilder, embed_sorted

torch.set_num_threads(2)  # the suite runs several test processes at once

TOL = 2e-5
ENC = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
           vocab_size=4096, max_position_embeddings=64, dtype="float32",
           max_length=64, length_buckets=(16, 32, 64))


def _write_csv(path: Path, n: int, seed: int = 0) -> str:
    syn = synthetic_corpus(n, seed=seed)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["code", "disease"])
        w.writerows(zip(syn.codes, syn.titles))
    return str(path)


def _configs(root: Path, weights: str):
    kw = dict(ENC, weights_path=weights)
    jcfg = jconfig.Config(
        encoder=jconfig.EncoderConfig(**kw),
        store=jconfig.StoreConfig(db_path=str(root / "jax" / "store"), pad_multiple=128),
        data_path=None,
    )
    tcfg = tconfig.Config(
        encoder=tconfig.EncoderConfig(**kw),
        store=tconfig.StoreConfig(db_path=str(root / "torch" / "store"), pad_multiple=128),
        data_path=None,
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("build")
    csv_path = _write_csv(root / "icd.csv", 300)
    weights = str(root / "weights.npz")
    arch = JArch(vocab_size=ENC["vocab_size"], hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128, max_position_embeddings=64,
                 compute_dtype=jnp.float32)
    save_params(jinit(arch, seed=0), weights)
    jcfg, tcfg = _configs(root, weights)
    assert JBuilder(jcfg).build_full_database(csv_path, rebuild=True)
    builder = DatabaseBuilder(tcfg, device="cpu")
    assert builder.build_full_database(csv_path, rebuild=True)
    return root, csv_path, jcfg, tcfg, builder


def test_same_vocab_and_metadata(built):
    root, _, jcfg, tcfg, _ = built
    jbase, tbase = jcfg.store.db_path, tcfg.store.db_path
    jvocab = Path(jbase + ".vocab.txt").read_bytes()
    assert Path(tbase + ".vocab.txt").read_bytes() == jvocab
    # the augmentation charset is in the vocab: synonym variants never [UNK]
    tok = WordPieceTokenizer.from_vocab_file(tbase + ".vocab.txt")
    for text in augment.augmentation_charset_texts():
        assert "[UNK]" not in tok.tokenize(text), text
    assert Path(tbase + ".meta.json").read_bytes() == Path(jbase + ".meta.json").read_bytes()
    jman = json.loads(Path(jbase + ".manifest.json").read_text())
    tman = json.loads(Path(tbase + ".manifest.json").read_text())
    for key in ("collection_name", "dim", "num_entities", "index_type", "metric_type"):
        assert tman[key] == jman[key], key
    jside = json.loads(Path(jbase + ".encoder.json").read_text())
    tside = json.loads(Path(tbase + ".encoder.json").read_text())
    assert tside["weights_path"] == jside["weights_path"]
    assert tside["model_name"] == jside["model_name"]
    assert tside["vocab_path"] == str(Path(tbase + ".vocab.txt").resolve())


def test_vectors_match_the_jax_builder(built):
    _, _, jcfg, tcfg, _ = built
    jv = np.load(jcfg.store.db_path + ".npz")["vectors"]
    tv = np.load(tcfg.store.db_path + ".npz")["vectors"]
    assert tv.shape == jv.shape == (300, 64) and tv.dtype == np.float32
    np.testing.assert_allclose(tv, jv, rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(tv, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_loads_the_others_store(built, writer):
    _, _, jcfg, tcfg, builder = built
    if writer == "jax":
        store = VectorStore.load(jcfg.store.db_path, config=tcfg.store, device="cpu")
        other = JStore.load(jcfg.store.db_path, config=jcfg.store)
    else:
        store = JStore.load(tcfg.store.db_path, config=jcfg.store)
        other = VectorStore.load(tcfg.store.db_path, config=tcfg.store, device="cpu")
    assert store.num_entities == other.num_entities == 300
    np.testing.assert_array_equal(store._vectors, other._vectors)
    qv = builder.encoder.encode_query(build_database.VERIFY_QUERY)
    got, want = store.search(qv, top_k=5)[0], other.search(qv, top_k=5)[0]
    assert [h.code for h in got] == [h.code for h in want]
    np.testing.assert_allclose([h.score for h in got], [h.score for h in want], atol=1e-5)


def test_verify_and_incremental_append(built, tmp_path):
    """An unflagged build over a CSV with new rows appends them (the same
    rows the JAX builder appends, with the same vectors); a second one
    changes nothing."""
    root, csv_path, jcfg, tcfg, _ = built
    for sub in ("jax", "torch"):
        shutil.copytree(root / sub, tmp_path / sub)
    jcfg = dataclasses.replace(jcfg, store=dataclasses.replace(
        jcfg.store, db_path=str(tmp_path / "jax" / "store")))
    tcfg = dataclasses.replace(tcfg, store=dataclasses.replace(
        tcfg.store, db_path=str(tmp_path / "torch" / "store")))
    bigger = _write_csv(tmp_path / "more.csv", 340)  # the 300 rows and 40 more
    tb = DatabaseBuilder(tcfg, device="cpu")
    assert tb.verify_database()
    assert JBuilder(jcfg).build_full_database(bigger)
    assert tb.build_full_database(bigger)
    store = VectorStore.load(tcfg.store.db_path, device="cpu")
    assert store.num_entities == 340
    jv = np.load(jcfg.store.db_path + ".npz")["vectors"]
    np.testing.assert_allclose(store._vectors, jv, rtol=0, atol=TOL)
    assert tb.build_full_database(bigger)  # idempotent
    assert VectorStore.load(tcfg.store.db_path, device="cpu").num_entities == 340


def test_hnsw_graph_persists_and_loads_in_both(built, tmp_path):
    root, _, jcfg, tcfg, _ = built
    shutil.copytree(root / "torch", tmp_path / "torch")
    tcfg = dataclasses.replace(tcfg, store=dataclasses.replace(
        tcfg.store, db_path=str(tmp_path / "torch" / "store")))
    path = DatabaseBuilder(tcfg, device="cpu").build_hnsw()
    assert Path(path).exists() and path == tcfg.store.db_path + ".hnsw"
    tstore = VectorStore.load(tcfg.store.db_path, device="cpu")
    jstore = JStore.load(tcfg.store.db_path)
    assert tstore._hnsw is not None and jstore._hnsw is not None
    assert len(tstore._hnsw) == len(jstore._hnsw) == 300


def test_main_cli_builds_and_verifies(built, tmp_path, monkeypatch):
    _, csv_path, _, tcfg, _ = built
    cfg = dataclasses.replace(tcfg, store=dataclasses.replace(
        tcfg.store, db_path=str(tmp_path / "cli" / "store")))
    monkeypatch.setattr(build_database, "get_config", lambda: cfg)
    assert build_database.main(["--input", csv_path, "--rebuild"], device="cpu") == 0
    assert VectorStore.exists(cfg.store.db_path)
    assert build_database.main(["--verify-only"], device="cpu") == 0
    missing = dataclasses.replace(cfg, store=dataclasses.replace(
        cfg.store, db_path=str(tmp_path / "none" / "store")))
    monkeypatch.setattr(build_database, "get_config", lambda: missing)
    assert build_database.main(["--verify-only"], device="cpu") == 1


def test_builder_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DatabaseBuilder(tconfig.Config())


class _FailingEncoder:
    """Embeds a batch as one-hot rows, or raises on the batch holding
    ``fail_on``."""

    dim = 4

    def __init__(self, exc, fail_on):
        self.exc, self.fail_on = exc, fail_on

    def encode_batch(self, texts, kind="passage"):
        assert kind == "query"
        if self.fail_on in texts:
            raise self.exc
        out = np.zeros((len(texts), self.dim), np.float32)
        out[np.arange(len(texts)), [len(t) % self.dim for t in texts]] = 1.0
        return out


def test_embed_sorted_zero_fills_a_failed_batch_and_counts_it():
    texts = ["aaaa", "b", "cc", "ddd", "eeeee", "f"]
    before = embed_sorted.failed_batches
    out = embed_sorted(_FailingEncoder(ValueError("bad text"), "cc"), texts, batch_size=2)
    assert embed_sorted.failed_batches == before + 1
    # the length-sorted batches are (b, f), (cc, ddd), (aaaa, eeeee)
    assert not out[[2, 3]].any()
    for row in (0, 1, 4, 5):
        assert out[row, len(texts[row]) % 4] == 1.0


def test_embed_sorted_reraises_a_device_error():
    before = embed_sorted.failed_batches
    with pytest.raises(RuntimeError, match="CUDA error"):
        embed_sorted(_FailingEncoder(RuntimeError("CUDA error: device-side assert"), "cc"),
                     ["a", "cc", "ddd"], batch_size=1)
    assert embed_sorted.failed_batches == before
