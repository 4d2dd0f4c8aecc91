"""The fused query engine's CUDA graphs and the NER classifier on a card.

These tests need an NVIDIA GPU and nvcc; they carry the ``gpu`` marker
and skip elsewhere. The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_fused.py -m gpu --noconftest -q

- A graph replay of ``FusedQueryEngine.query`` (BERT forward, K1 or K2,
  ``torch.topk``) against the eager two-step path (the encoder, then the
  kernel's plain version, then ``torch.topk``) for exact, approx and
  streaming over fp32 and bf16 residency: embeddings within 1e-5 (the
  same kernels, replayed), values within 5e-5 (fp32 sums of D products
  in two orders, tests/test_torch_cuda_kernels.py's tolerance), the same
  ids up to ties within it; streaming certified, never redone.
- Launch counts: the capture moves none, each replay exactly
  ``replay_launches(k, method)``.
- Replays from several threads at once give the sequential results
  (the engine's lock); a store reload drops and recaptures the graphs.
- The NER classifier on the card against the same model on the CPU:
  probabilities within 1e-5 at fp32 compute (the same spans) and within
  2e-2 at bf16, the served dtype (bf16 rounds at other places on the
  two devices).
- A capture that fails raises; the engine does not fall back to eager.
"""

import json
import threading

import numpy as np
import pytest
import torch

from rag_icd10_tpu_torch.config import EncoderConfig, StoreConfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.index.vector_store import VectorStore
from rag_icd10_tpu_torch.models.bert import BertArch, init_params
from rag_icd10_tpu_torch.models.convert_hf import save_params
from rag_icd10_tpu_torch.models.encoder import TextEncoder
from rag_icd10_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_icd10_tpu_torch.ops import fused_score
from rag_icd10_tpu_torch.ops.flat_topk import weighted_scores_reference
from rag_icd10_tpu_torch.ops.fused_query import FusedQueryEngine, replay_launches
from rag_icd10_tpu_torch.pipeline.ner_model import TorchTokenClassifier

TOL = 5e-5
TEXTS = ["急性胃肠炎", "高血压病3级", "慢性肝炎", "疑似肺部感染", "2型糖尿病",
         "复发性胃溃疡", "急性心梗死", "肾功能不全", "冠状动脉粥样硬化性心脏病",
         "慢性阻塞性肺疾病急性加重"]
SMALL = dict(hidden_size=128, num_layers=2, num_heads=4, intermediate_size=256,
             max_position_embeddings=128, max_length=128, length_buckets=(16, 32, 64, 128))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


_CACHE = {}


def _deployment(dev, residency="float32"):
    """A small bf16 encoder and a 3,000-row store it embedded, on the card."""
    key = residency
    if key not in _CACHE:
        corpus = synthetic_corpus(3000, seed=1)
        tok = WordPieceTokenizer.from_corpus(corpus.titles + TEXTS)
        enc = TextEncoder(EncoderConfig(vocab_size=tok.vocab_size, **SMALL),
                          tokenizer=tok, seed=0, device=dev)
        store = VectorStore(dim=SMALL["hidden_size"],
                            config=StoreConfig(device_dtype=residency), device=dev)
        store.insert_records(list(corpus.records()),
                             enc.encode_batch(corpus.titles, kind="query"))
        store.load_collection()
        _CACHE[key] = (enc, store)
    return _CACHE[key]


def _eager(enc, store, texts, k):
    """The two-step path with the plain scoring version."""
    emb = enc.encode_queries_device(texts)
    dev = store._dev
    corpus = dev["corpus"]
    scores = weighted_scores_reference(emb.to(corpus.dtype), corpus, dev["weights"], dev["mask"])
    vals, idx = torch.topk(scores, k, dim=1)
    return emb.cpu().numpy(), vals.cpu().numpy(), idx.cpu().numpy()


def _same_up_to_ties(got_v, got_i, want_v, want_i, what):
    np.testing.assert_allclose(got_v, want_v, atol=TOL, rtol=0, err_msg=what)
    for gv, gi, wv, wi in zip(got_v, got_i, want_v, want_i):
        g, w = dict(zip(gi.tolist(), gv.tolist())), dict(zip(wi.tolist(), wv.tolist()))
        for j in g.keys() ^ w.keys():
            assert abs(g.get(j, w.get(j)) - float(wv[-1])) <= TOL, (what, j)


@pytest.mark.gpu
@pytest.mark.parametrize("residency", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["exact", "approx", "streaming"])
@pytest.mark.parametrize("n,k", [(3, 16), (10, 32), (40, 128)])
def test_replay_matches_eager(cuda, residency, method, n, k):
    enc, store = _deployment(cuda, residency)
    texts = (TEXTS * 4)[:n]
    engine = FusedQueryEngine(enc, store)
    emb, vals, idx = engine.query(texts, k=k, method=method)
    emb2, vals2, idx2 = engine.query(texts, k=k, method=method)  # a pure replay
    want_emb, want_vals, want_idx = _eager(enc, store, texts, k)
    what = f"{residency} {method} n={n} k={k}"
    np.testing.assert_allclose(emb, want_emb, atol=1e-5, rtol=0, err_msg=what)
    _same_up_to_ties(vals, idx, want_vals, want_idx, what)
    np.testing.assert_array_equal(vals2, vals)
    np.testing.assert_array_equal(idx2, idx)
    stats = engine.stats()
    assert stats["graphs"] == 1 and stats["replays"] == 2 and stats["eager"] == 0
    if method == "streaming":
        assert stats["certified"] == stats["streaming_queries"] == 2 * n
        assert stats["redos"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("method,k", [("exact", 16), ("approx", 32),
                                      ("streaming", 16), ("streaming", 200)])
def test_launch_counts_per_replay(cuda, method, k):
    enc, store = _deployment(cuda)
    engine = FusedQueryEngine(enc, store)
    before = fused_score.launch_counts()
    engine.query(TEXTS[:3], k=k, method=method)  # warm-up launch, capture, replay
    first = np.subtract(fused_score.launch_counts(), before)
    per = np.array(replay_launches(k, method))
    # the eager warm-up before capture launched once; the capture none
    np.testing.assert_array_equal(first, 2 * per)
    mid = fused_score.launch_counts()
    for _ in range(3):
        engine.query(TEXTS[3:6], k=k, method=method)
    np.testing.assert_array_equal(np.subtract(fused_score.launch_counts(), mid), 3 * per)


@pytest.mark.gpu
def test_threads_share_the_graphs_safely(cuda):
    enc, store = _deployment(cuda)
    engine = FusedQueryEngine(enc, store)
    jobs = [(TEXTS[i : i + 3], k) for i in range(0, 8) for k in (16, 32)]
    want = [engine.query(texts, k=k) for texts, k in jobs]
    got = [None] * len(jobs)

    def worker(start):
        for j in range(start, len(jobs), 4):
            got[j] = engine.query(*jobs[j])

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for (w_emb, w_vals, w_idx), (emb, vals, idx) in zip(want, got):
        np.testing.assert_array_equal(emb, w_emb)
        np.testing.assert_array_equal(vals, w_vals)
        np.testing.assert_array_equal(idx, w_idx)


@pytest.mark.gpu
def test_reload_recaptures(cuda):
    enc, store = _deployment(cuda)
    engine = FusedQueryEngine(enc, store)
    _, want_vals, want_idx = engine.query(TEXTS[:2], k=16)
    store.release_collection()
    store.load_collection()
    _, vals, idx = engine.query(TEXTS[:2], k=16)
    assert engine.stats()["graphs"] == 2
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_allclose(vals, want_vals, atol=0)


LABELS = ("O", "B-Disease", "I-Disease", "B-Symptom", "I-Symptom",
          "B-BodyParts", "I-BodyParts", "B-Drug", "I-Drug")


@pytest.fixture(scope="module")
def ner_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ner")
    tok = WordPieceTokenizer.from_corpus(TEXTS)
    arch = BertArch(vocab_size=tok.vocab_size, hidden_size=128, num_layers=2,
                    num_heads=4, intermediate_size=256, max_position_embeddings=64)
    params = init_params(arch, seed=0)
    rng = np.random.default_rng(1)
    params["classifier"] = {
        "kernel": rng.standard_normal((128, len(LABELS)), dtype=np.float32) * np.float32(0.3),
        "bias": np.zeros(len(LABELS), np.float32),
    }
    save_params(params, str(d / "params.npz"))
    tok.save_vocab(str(d / "vocab.txt"))
    (d / "config.json").write_text(json.dumps({
        "vocab_size": tok.vocab_size, "hidden_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 256, "max_position_embeddings": 64,
        "id2label": {str(i): label for i, label in enumerate(LABELS)},
    }))
    return d


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_ner_on_card_matches_cpu(cuda, ner_dir, dtype, tol):
    card = TorchTokenClassifier.from_weights(str(ner_dir), device=cuda, compute_dtype=dtype)
    host = TorchTokenClassifier.from_weights(str(ner_dir), device="cpu", compute_dtype=dtype)
    for text in TEXTS + ["".join(TEXTS)]:  # the last one past the position table
        _, _, ids, mask = host.encode(text)
        np.testing.assert_allclose(card.probabilities(ids, mask), host.probabilities(ids, mask),
                                   atol=tol, rtol=0, err_msg=text)
        if dtype == torch.float32:
            got, want = card.predict(text), host.predict(text)
            assert [s[:2] + s[3:] for s in got] == [s[:2] + s[3:] for s in want], text
            np.testing.assert_allclose([s[2] for s in got], [s[2] for s in want], atol=tol)


@pytest.mark.gpu
def test_capture_failure_raises(cuda, monkeypatch):
    """A host sync inside the captured chain breaks the capture: the query
    raises, and nothing is served eagerly in its place."""
    enc, store = _deployment(cuda)
    engine = FusedQueryEngine(enc, store)
    compute = engine._compute

    def syncing(*args):
        out = compute(*args)
        out[1][0, 0].item()  # a device->host read: not capturable
        return out

    monkeypatch.setattr(engine, "_compute", syncing)
    with pytest.raises(RuntimeError):
        engine.query(TEXTS[:2], k=16)
    assert engine.stats()["replays"] == 0 and engine.stats()["eager"] == 0
    torch.cuda.synchronize()
    # the card still serves: a fresh engine captures and replays
    _, vals, _ = FusedQueryEngine(enc, store).query(TEXTS[:2], k=16)
    assert np.isfinite(vals).all()
