"""The retrieval eval (eval/retrieval.py, tools/eval_retrieval.py) and the
eval gate (tools/train_encoder.run_eval_gate) of the port against the JAX
package's, on the CPU.

- The eval set is host-side numpy over data/augment.py: the port's tiers
  equal the JAX package's case for case.
- ``evaluate`` over the same encoder (the deterministic MockEncoder of
  tests/test_orchestrator.py) and the same rows gives the same report,
  every recall equal: both stores score in IEEE fp32 and the mock's
  vectors are not near-tied.
- The gate over the same tiny BERT (2 layers, 32 wide, fp32 compute, the
  same parameters) gives the JAX gate's tier numbers within one case per
  tier (1/n): the two encoders' embeddings agree within about 1e-6, and a
  near-tie between two candidates may fall either way.
- The cases of tests/test_eval.py and tests/test_eval_gate.py run on the
  port, including the checked-in ``EVAL_GATE_r04*.json`` artifacts.
"""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rag_icd10_tpu.config import EncoderConfig as JEncoderConfig
from rag_icd10_tpu.config import NERConfig as JNERConfig
from rag_icd10_tpu.config import StoreConfig as JStoreConfig
from rag_icd10_tpu.data.corpus import ICDCorpus as JCorpus
from rag_icd10_tpu.data.corpus import synthetic_corpus as jsynthetic
from rag_icd10_tpu.eval import retrieval as jret
from rag_icd10_tpu.index import VectorStore as JStore
from rag_icd10_tpu.models.bert import BertArch as JArch
from rag_icd10_tpu.models.bert import init_params as jinit
from rag_icd10_tpu.models.tokenizer import WordPieceTokenizer as JTok
from rag_icd10_tpu.pipeline.ner import MedicalNERService as JNER
from rag_icd10_tpu.pipeline.orchestrator import MultiDiagnosisService as JMatcher
from rag_icd10_tpu.pipeline.textproc import DiagnosisTextProcessor as JProc
from rag_icd10_tpu.tools import train_encoder as jtool
from rag_icd10_tpu_torch import config as tconfig
from rag_icd10_tpu_torch.data.corpus import ICDCorpus, synthetic_corpus
from rag_icd10_tpu_torch.eval import retrieval as tret
from rag_icd10_tpu_torch.index.vector_store import VectorStore
from rag_icd10_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_icd10_tpu_torch.pipeline.ner import MedicalNERService
from rag_icd10_tpu_torch.pipeline.orchestrator import MultiDiagnosisService
from rag_icd10_tpu_torch.pipeline.textproc import DiagnosisTextProcessor
from rag_icd10_tpu_torch.tools import train_encoder as ttool

from test_orchestrator import CORPUS_ROWS, MockEncoder

torch.set_num_threads(2)  # the suite runs several test processes at once

REPO = Path(__file__).resolve().parent.parent


def _cases(tiers):
    return [(t.name, [(c.query, sorted(c.gold_titles), c.source_title) for c in t.cases])
            for t in tiers]


# ---------------------------------------------------------------- eval set


@pytest.mark.parametrize("n,seed,sizes", [
    (300, 77, {}),
    (2000, 5, dict(n_exact=50, n_paraphrase=60, n_uncertainty=40, n_multi=20)),
])
def test_eval_set_matches_jax(n, seed, sizes):
    got = tret.build_eval_set(synthetic_corpus(n, seed=seed), seed=seed, **sizes)
    want = jret.build_eval_set(jsynthetic(n, seed=seed), seed=seed, **sizes)
    assert _cases(got) == _cases(want)


@pytest.fixture(scope="module")
def corpus():
    return synthetic_corpus(300, seed=77)


def test_eval_set_deterministic_and_tiered(corpus):
    a, b = tret.build_eval_set(corpus, seed=5), tret.build_eval_set(corpus, seed=5)
    assert _cases(a) == _cases(b)
    tiers = {t.name: t for t in tret.build_eval_set(corpus)}
    assert set(tiers) == {"exact_title", "paraphrase", "uncertainty", "multi_diagnosis"}
    for c in tiers["uncertainty"].cases[:20]:
        assert c.source_title in c.query and c.query != c.source_title
    for c in tiers["paraphrase"].cases:
        assert c.query not in c.gold_titles


def test_exact_tier_admits_separator_titles():
    rows = [{"code": f"A{i:02d}", "disease": t} for i, t in enumerate([
        "肺结核,经组织学所证实", "急性胃肠炎", "高血压病", "慢性支气管炎",
        "继发性肺结核(初治,耐多药)涂阳培阳", "糖尿病性白内障",
    ])]
    tiers = {t.name: t for t in tret.build_eval_set(
        ICDCorpus.from_rows(rows), n_exact=6, n_paraphrase=2, n_uncertainty=2, n_multi=2)}
    assert "肺结核,经组织学所证实" in {c.query for c in tiers["exact_title"].cases}
    for c in tiers["uncertainty"].cases:
        assert "," not in c.source_title


def test_multi_pool_excludes_merge_prone_titles(corpus):
    from rag_icd10_tpu_torch.pipeline.boundary import (
        CONNECTION_PATTERNS,
        DISEASE_TERM_RE,
        QUALIFIER_TAIL_RE,
    )

    tiers = {t.name: t for t in tret.build_eval_set(corpus)}
    for c in tiers["multi_diagnosis"].cases:
        t = c.source_title
        assert not any(p.search(t) for p in CONNECTION_PATTERNS), t
        assert not (QUALIFIER_TAIL_RE.search(t) and not DISEASE_TERM_RE.search(t)), t


# ---------------------------------------------------------------- evaluate


class TitleLookupEncoder(MockEncoder):
    """A text -> the embedding of the corpus record whose title it contains
    (longest match): a perfect retriever."""

    def __init__(self, corpus, vectors):
        self.titles = list(corpus.titles)
        self.vectors = vectors

    def _vec(self, text):
        best, best_len = None, 0
        for i, t in enumerate(self.titles):
            if t in text and len(t) > best_len:
                best, best_len = i, len(t)
        return super()._vec(text) if best is None else self.vectors[best]


def _setup(rows=CORPUS_ROWS, seed=3, encoder=TitleLookupEncoder):
    corpus = ICDCorpus.from_rows(rows)
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((len(corpus), 64)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    enc = encoder(corpus, vecs) if encoder is TitleLookupEncoder else encoder()
    store = VectorStore(dim=64, config=tconfig.StoreConfig(pad_multiple=128), device="cpu")
    store.insert_records(list(corpus.records()), vecs)
    return enc, store, corpus


def _matcher(enc, store):
    ner = MedicalNERService(tconfig.NERConfig(use_model=False), device="cpu")
    return MultiDiagnosisService(
        encoder=enc, store=store, ner_service=ner,
        text_processor=DiagnosisTextProcessor(use_enhanced_processing=True, ner_service=ner),
    )


def test_perfect_retriever_scores_one():
    enc, store, corpus = _setup()
    tiers = tret.build_eval_set(corpus, n_exact=8, n_paraphrase=0, n_uncertainty=8, n_multi=0)
    t = tret.evaluate(enc, store, tiers=tiers, top_k=5)["tiers"]
    assert t["exact_title"]["recall@1"] == 1.0 and t["exact_title"]["n"] == 8
    assert t["uncertainty"]["recall@1"] == 1.0
    assert "recall@1_unweighted" in t["exact_title"]  # the store's host rows


def test_duplicate_titles_count_as_correct():
    rows = CORPUS_ROWS + [{"code": "K52.905", "disease": "急性胃肠炎"}]
    enc, store, _ = _setup(rows, seed=4)
    tier = tret.EvalTier("exact_title", [tret.EvalCase("急性胃肠炎", {"急性胃肠炎"}, "急性胃肠炎")])
    assert tret.evaluate(enc, store, tiers=[tier], top_k=5)["tiers"]["exact_title"][
        "recall@1"] == 1.0


def test_full_pipeline_tiers_and_canonical_rows():
    enc, store, corpus = _setup()
    matcher = _matcher(enc, store)
    tiers = tret.build_eval_set(corpus, n_exact=4, n_paraphrase=0, n_uncertainty=4, n_multi=4)
    t = tret.evaluate(enc, store, matcher=matcher, tiers=tiers, top_k=5)["tiers"]
    assert t["exact_title"]["pipeline_top1"] == 1.0
    assert "sub_diagnosis_top1" in t["multi_diagnosis"]
    assert t["multi_diagnosis"]["avg_extracted"] >= 1
    rows = tret.run_canonical(matcher)
    assert len(rows) == len(tret.CANONICAL_TEXTS)
    assert all(set(r) == {"text", "extracted", "top1"} for r in rows)


@pytest.mark.parametrize("encoder", ["title_lookup", "mock"])
def test_evaluate_matches_jax(encoder):
    """The same encoder over the same rows: the same report (the mock
    scores every query by hashing, so the tiers' raw recall varies)."""
    corpus_rows = CORPUS_ROWS
    cls = TitleLookupEncoder if encoder == "title_lookup" else MockEncoder
    enc, store, corpus = _setup(corpus_rows, encoder=cls)
    jcorpus = JCorpus.from_rows(corpus_rows)
    jstore = JStore(dim=64, config=JStoreConfig(pad_multiple=128))
    jstore.insert_records(list(jcorpus.records()), store._vectors)
    jner = JNER(JNERConfig(use_model=False))
    jmatcher = JMatcher(encoder=enc, store=jstore, ner_service=jner,
                        text_processor=JProc(use_enhanced_processing=True, ner_service=jner))
    sizes = dict(n_exact=12, n_paraphrase=8, n_uncertainty=10, n_multi=6)
    got = tret.evaluate(enc, store, matcher=_matcher(enc, store),
                        tiers=tret.build_eval_set(corpus, **sizes), top_k=5)
    want = jret.evaluate(enc, jstore, matcher=jmatcher,
                         tiers=jret.build_eval_set(jcorpus, **sizes), top_k=5)
    assert got["tiers"] == want["tiers"]
    assert got["corpus_size"] == want["corpus_size"] and got["top_k"] == want["top_k"]


def test_save_report_round_trips(tmp_path):
    report = {"tiers": {"exact_title": {"n": 1, "recall@1": 1.0}}, "note": "急性胃肠炎"}
    tret.save_report(report, str(tmp_path / "r.json"))
    assert json.loads((tmp_path / "r.json").read_text(encoding="utf-8")) == report


# ---------------------------------------------------------------- the gate


@pytest.fixture(scope="module")
def gate_env(tmp_path_factory):
    """The JAX gate test's tiny environment, for both packages: a 40-row
    synthetic corpus, a 2-layer 32-wide fp32 BERT and its JAX-layout
    parameters (seed 0)."""
    corpus, jcorpus = synthetic_corpus(40, seed=3), jsynthetic(40, seed=3)
    texts = list(corpus.titles) + list(corpus.semantic_texts)
    tok, jtok = WordPieceTokenizer.from_corpus(texts), JTok.from_corpus(texts)
    dims = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
    enc = dict(model_name="tiny-test", vocab_size=tok.vocab_size, dtype="float32",
               weights_path=None, vocab_path=None, **dims)
    import jax

    params = jax.device_get(jinit(JArch(vocab_size=tok.vocab_size, **dims), seed=0))
    params = jax.tree_util.tree_map(np.asarray, params)
    store_dir = tmp_path_factory.mktemp("store")
    cfg = SimpleNamespace(encoder=tconfig.EncoderConfig(**enc),
                          store=tconfig.StoreConfig(db_path=str(store_dir / "s")))
    jcfg = SimpleNamespace(encoder=JEncoderConfig(**enc),
                           store=JStoreConfig(db_path=str(store_dir / "j")))
    return params, (tok, corpus, cfg), (jtok, jcorpus, jcfg)


def _gate(gate_env, out, baseline, metric="paraphrase"):
    params, (tok, corpus, cfg), _ = gate_env
    blessed = ttool.run_eval_gate(params, tok, corpus, out, baseline, cfg,
                                  metric=metric, device="cpu")
    return blessed, json.loads((out / "eval_gate.json").read_text())


def test_gate_matches_jax(gate_env, tmp_path):
    params, _, (jtok, jcorpus, jcfg) = gate_env
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    blessed, got = _gate(gate_env, tmp_path / "t", "0.0")
    assert jtool.run_eval_gate(params, jtok, jcorpus, tmp_path / "j", "0.0", jcfg) is blessed
    want = json.loads((tmp_path / "j" / "eval_gate.json").read_text())
    assert set(got) == set(want) and got["gate_metric"] == want["gate_metric"]
    assert set(got["tiers"]) == set(want["tiers"])
    for name, tier in want["tiers"].items():
        assert set(got["tiers"][name]) == set(tier), name
        one_case = 1.0 / tier["n"]
        for key, value in tier.items():
            if key in ("n", "queries"):
                assert got["tiers"][name][key] == value, (name, key)
            else:
                assert abs(got["tiers"][name][key] - value) <= one_case + 1e-4, (name, key)


def test_gate_blesses_at_or_above_float_baseline(gate_env, tmp_path):
    blessed, gate = _gate(gate_env, tmp_path, "0.0")
    assert blessed is True and gate["blessed"] is True
    assert gate["gate_metric"] == "paraphrase.pipeline_top1" and gate["baseline"] == 0.0
    assert 0.0 <= gate["candidate"] <= 1.0
    para = gate["tiers"]["paraphrase"]
    assert para["n"] > 0 and gate["candidate"] == pytest.approx(para["pipeline_top1"])


def test_gate_rejects_below_unreachable_baseline(gate_env, tmp_path):
    blessed, gate = _gate(gate_env, tmp_path, "1.01")
    assert blessed is False and gate["blessed"] is False


def test_gate_reads_baseline_from_incumbent_json(gate_env, tmp_path):
    incumbent = tmp_path / "incumbent.json"
    incumbent.write_text(json.dumps({"tiers": {"paraphrase": {"pipeline_top1": 1.01}}}))
    blessed, gate = _gate(gate_env, tmp_path, str(incumbent))
    assert blessed is False and gate["baseline"] == 1.01


def test_gate_blend_metric(gate_env, tmp_path):
    blessed, gate = _gate(gate_env, tmp_path, "0.0", metric="blend")
    assert blessed is True and gate["gate_metric"] == "blend(4-tier mean)"
    t = gate["tiers"]
    expected = (t["exact_title"]["pipeline_top1"] + t["paraphrase"]["pipeline_top1"]
                + t["uncertainty"]["pipeline_top1"]
                + t["multi_diagnosis"]["sub_diagnosis_top1"]) / 4
    assert gate["candidate"] == pytest.approx(expected)


@pytest.mark.parametrize("artifact,paraphrase,blend", [
    ("EVAL_r02.json", 0.9125, 0.956675),
    ("EVAL_GATE_r04.json", 0.8825, 0.95125),
    ("EVAL_GATE_r04_incumbent_cpu.json", None, None),
    ("EVAL_GATE_r04_step8000_cpu.json", None, None),
])
def test_gate_metric_on_checked_in_artifacts(artifact, paraphrase, blend):
    tiers = json.loads((REPO / artifact).read_text(encoding="utf-8"))["tiers"]
    for metric, pinned in (("paraphrase", paraphrase), ("blend", blend)):
        got = ttool.gate_metric_value(tiers, metric)
        assert got == jtool.gate_metric_value(tiers, metric)
        if pinned is not None:
            assert got == pytest.approx(pinned, abs=1e-4)
        assert 0.5 < got <= 1.0


def test_unknown_gate_metric_raises():
    with pytest.raises(ValueError):
        ttool.gate_metric_value({}, "qps")


# ----------------------------------------------------- tools/eval_retrieval


def test_eval_cli_over_a_built_store(tmp_path, monkeypatch):
    """tools/eval_retrieval.py over the port's Engine on the CPU: a store
    built by the port's builder with a tiny encoder, then the report."""
    from rag_icd10_tpu_torch import runtime
    from rag_icd10_tpu_torch.tools import build_database, eval_retrieval

    corpus = synthetic_corpus(200, seed=8)
    csv = tmp_path / "icd.csv"
    csv.write_text("code,disease\n" + "\n".join(
        f"{r.code},{r.preferred_zh}" for r in corpus.records()), encoding="utf-8")
    base = tconfig.Config()
    cfg = dataclasses.replace(
        base, data_path=str(csv),
        encoder=tconfig.EncoderConfig(hidden_size=32, num_layers=2, num_heads=2,
                                      intermediate_size=64, weights_path=None,
                                      vocab_path=None, dtype="float32"),
        store=dataclasses.replace(base.store, db_path=str(tmp_path / "db" / "icd")),
        ner=tconfig.NERConfig(use_model=False),
    )
    for module in (tconfig, runtime, build_database):
        monkeypatch.setattr(module, "get_config", lambda: cfg)
    assert build_database.DatabaseBuilder(config=cfg, device="cpu").build_full_database(
        str(csv), rebuild=True)
    out = tmp_path / "EVAL.json"
    assert eval_retrieval.main(["--out", str(out), "--n-exact", "20", "--n-paraphrase", "10",
                                "--n-uncertainty", "10", "--n-multi", "5"], device="cpu") == 0
    report = json.loads(out.read_text(encoding="utf-8"))
    assert set(report["tiers"]) == {"exact_title", "paraphrase", "uncertainty",
                                    "multi_diagnosis"}
    assert report["tiers"]["exact_title"]["n"] == 20
    assert "recall@1_unweighted" in report["tiers"]["exact_title"]
    assert len(report["canonical"]) == len(tret.CANONICAL_TEXTS)
    assert report["encoder"]["device"] == "cpu"
