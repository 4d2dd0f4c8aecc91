"""NER training on a card (rag_icd10_tpu_torch/tools/train_ner.py).

These tests need an NVIDIA GPU; they carry the ``gpu`` marker and skip
elsewhere. The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_train_ner.py -m gpu --noconftest -q

- Three seeded steps of a 2-layer, 32-wide token classifier on the card
  against the same steps on the CPU, from the same seeded weights and the
  tool's batches: at fp32 compute every loss within 5e-5 and every
  parameter within 1e-4 but the attention key biases, held to 2·Σ lr
  (their gradient is zero in exact arithmetic, so Adam turns each
  device's rounding noise into updates of up to the learning rate:
  tests/test_torch_train_ner.py); at bf16 compute the losses within 2e-2
  (bf16 rounds at other places on the two devices). The parameters stay
  fp32 on the card.
- A tiny ``main()`` on ``cuda`` writes a directory that
  ``MedicalNERService`` loads in model mode on ``cuda``, and its eval.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rag_icd10_tpu_torch.config import NERConfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.parallel.train import warmup_cosine_decay_schedule
from rag_icd10_tpu_torch.pipeline.ner import MedicalNERService
from rag_icd10_tpu_torch.tools import train_ner

pytestmark = pytest.mark.gpu

SEQ = 32


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the training step runs on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def titles():
    return train_ner.disease_titles(synthetic_corpus(300, seed=3))


def _run(arch, titles, device):
    tok = train_ner.build_vocab(titles)
    label_to_id = {l: i for i, l in enumerate(train_ner.LABELS)}
    rng = np.random.default_rng(0)
    schedule = warmup_cosine_decay_schedule(0.0, 3e-4, 2, 10)
    state = train_ner.init_ner_state(arch, schedule, seed=0, device=device)
    losses = []
    for _ in range(3):
        examples = train_ner.draw_examples(rng, titles, 8)
        loss, acc = train_ner.ner_train_step(
            state, *train_ner.make_batch(tok, examples, label_to_id, SEQ))
        assert loss.device.type == torch.device(device).type
        losses.append(float(loss))
    return state, losses, [schedule(i) for i in range(3)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.bfloat16, 2e-2)])
def test_card_steps_match_the_cpu(cuda, titles, dtype, tol):
    vocab = train_ner.build_vocab(titles).vocab_size
    arch = dataclasses.replace(train_ner.ner_arch(vocab, 32, 2, SEQ), compute_dtype=dtype)
    card, card_losses, lrs = _run(arch, titles, cuda)
    host, host_losses, _ = _run(arch, titles, "cpu")
    np.testing.assert_allclose(card_losses, host_losses, rtol=0, atol=tol)
    assert all(p.dtype == torch.float32 and p.device.type == "cuda"
               for p in card.model.parameters())
    if dtype == torch.float32:
        for (name, a), b in zip(card.model.named_parameters(), host.model.parameters()):
            limit = 2 * sum(lrs) * 1.01 + 1e-4 if name.endswith("key.bias") else 1e-4
            assert float((a.detach().cpu() - b.detach()).abs().max()) <= limit, name


def test_main_on_the_card_writes_weights_the_service_serves(cuda, tmp_path, monkeypatch):
    corpus = synthetic_corpus(300, seed=3)
    csv = tmp_path / "icd.csv"
    csv.write_text("code,disease\n" + "\n".join(
        f"{r.code},{r.preferred_zh}" for r in corpus.records()), encoding="utf-8")
    monkeypatch.setenv("ICD_DATA_PATH", str(csv))
    monkeypatch.setenv("NER_WEIGHTS_PATH", "")
    out = tmp_path / "ner"
    rc = train_ner.main(["--steps", "20", "--batch", "16", "--seq", str(SEQ), "--hidden", "64",
                         "--layers", "2", "--log-every", "10", "--out", str(out)])
    assert rc == 0
    report = json.loads((out / "eval.json").read_text())
    assert set(report) == {"model", "rules", "note"}
    monkeypatch.setenv("NER_WEIGHTS_PATH", str(out))
    svc = MedicalNERService(NERConfig(use_model=True), device="cuda")
    assert svc.use_model and svc._model is not None, svc.fallback_reason
    assert next(svc._model.model.parameters()).device.type == "cuda"
    ents = svc.extract_medical_entities("患者诊断为急性胃肠炎，伴腹痛", filter_drugs=False)
    assert isinstance(ents, dict) and svc.stats()["rule_fallbacks"] == 0
    assert svc.stats()["model_extractions"] == 1
