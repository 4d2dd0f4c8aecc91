"""Encoder training and the eval gate on a card.

These tests need an NVIDIA GPU (and nvcc for K1, which the gate's searches
launch); they carry the ``gpu`` marker and skip elsewhere. The file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_train.py -m gpu --noconftest -q

- Three seeded steps of a 2-layer, 64-wide BERT on the card against the
  same steps on the CPU: at fp32 compute the loss of each step within
  5e-5 (cuBLAS sums in other orders than the CPU, and Adam turns
  rounding-level gradient differences in elements near zero into update
  differences of up to the learning rate: two CPU implementations drift
  apart by 5e-6 over the same steps, tests/test_torch_train.py) and
  every parameter within 1e-4 but the attention key biases,
  whose gradient is zero in exact arithmetic and whose Adam updates are
  rounding noise of either sign (held to 2·Σ lr: tests/test_torch_train.py
  gives the reason); at bf16 compute the losses within 2e-2 (bf16 rounds
  at other places on the two devices). The parameters stay fp32 on the
  card, and the gradients reach them.
- The data-parallel step over an NCCL group of world size 1 equals the
  plain step to the bit.
- ``run_eval_gate`` on the card: blessed at baseline 0, with K1 launched by
  its searches.
"""

import json
import socket
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rag_icd10_tpu_torch import config as tconfig
from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
from rag_icd10_tpu_torch.models.bert import BertArch, init_params
from rag_icd10_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_icd10_tpu_torch.ops import fused_score
from rag_icd10_tpu_torch.parallel import train as ttrain
from rag_icd10_tpu_torch.parallel.train import init_train_state, make_train_step

pytestmark = pytest.mark.gpu

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=32)
LR = 1e-3


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the training step runs on the card")
    return torch.device("cuda")


def _batch(seed, b=8):
    r = np.random.default_rng(seed)
    batch = {}
    for name, seq in (("a", 16), ("b", 24), ("h", 16)):
        ids = r.integers(1, 128, size=(b, seq)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[:, seq - 3:] = 0
        batch.update({f"{name}_ids": ids, f"{name}_mask": mask,
                      f"{name}_types": np.zeros_like(ids)})
    batch.update(group_a=np.arange(b, dtype=np.int32),
                 group_b=np.arange(b, 2 * b, dtype=np.int32),
                 h_group=np.arange(2 * b, 3 * b, dtype=np.int32),
                 w_b=r.choice([0.8, 1.0, 1.2], b).astype(np.float32),
                 w_h=r.choice([0.8, 1.0, 1.2], b).astype(np.float32))
    return batch


def _run(arch, device, steps=3):
    schedule = ttrain.warmup_cosine_decay_schedule(0.0, LR, 1, 10)
    state = init_train_state(arch, params=init_params(arch, seed=0), schedule=schedule,
                             device=device)
    step = make_train_step()
    losses = [float(step(state, _batch(i))["loss"]) for i in range(steps)]
    return state, losses, [schedule(i) for i in range(steps)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (torch.bfloat16, 2e-2)])
def test_card_steps_match_the_cpu(cuda, dtype, tol):
    arch = BertArch(**TINY, compute_dtype=dtype)
    card, card_losses, lrs = _run(arch, cuda)
    host, host_losses, _ = _run(arch, "cpu")
    np.testing.assert_allclose(card_losses, host_losses, rtol=0, atol=tol)
    assert all(p.dtype == torch.float32 and p.device.type == "cuda"
               for p in card.model.parameters())
    if dtype == torch.float32:
        for (name, a), b in zip(card.model.named_parameters(), host.model.parameters()):
            limit = 2 * sum(lrs) * 1.01 + 1e-4 if name.endswith("key.bias") else 1e-4
            assert float((a.detach().cpu() - b.detach()).abs().max()) <= limit, name


def test_nccl_world_size_one_step_equals_the_plain_step(cuda):
    from rag_icd10_tpu_torch.parallel import make_mesh, multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda", timeout_s=60)
    try:
        mesh = make_mesh(dp=1, tp=1)
        arch = BertArch(**TINY, compute_dtype=torch.float32)
        params = init_params(arch, seed=1)
        dp = init_train_state(arch, mesh=mesh, params=params, schedule=LR)
        plain = init_train_state(arch, params=params, schedule=LR, device=cuda)
        step_dp, step = ttrain.make_sharded_train_step(mesh), make_train_step()
        for i in range(2):
            assert float(step_dp(dp, _batch(i))["loss"]) == float(step(plain, _batch(i))["loss"])
        for a, b in zip(dp.model.parameters(), plain.model.parameters()):
            assert torch.equal(a, b)
    finally:
        multihost.shutdown()


def test_eval_gate_on_the_card_launches_k1(cuda, tmp_path):
    from rag_icd10_tpu_torch.tools.train_encoder import run_eval_gate

    corpus = synthetic_corpus(300, seed=3)
    tok = WordPieceTokenizer.from_corpus(list(corpus.titles) + list(corpus.semantic_texts))
    dims = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
    cfg = SimpleNamespace(
        encoder=tconfig.EncoderConfig(vocab_size=tok.vocab_size, weights_path=None,
                                      vocab_path=None, **dims),
        store=tconfig.StoreConfig(db_path=str(tmp_path / "s")),
    )
    params = init_params(BertArch(vocab_size=tok.vocab_size, **dims), seed=0)
    fused_score.fused_weighted_scores.launches = 0
    assert run_eval_gate(params, tok, corpus, tmp_path, "0.0", cfg, device=cuda) is True
    assert fused_score.fused_weighted_scores.launches > 0
    gate = json.loads((tmp_path / "eval_gate.json").read_text())
    assert gate["blessed"] is True and gate["tiers"]["paraphrase"]["n"] > 0
