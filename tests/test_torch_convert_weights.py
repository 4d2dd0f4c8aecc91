"""HF checkpoint conversion of the port against the JAX package's, on the CPU.

- ``convert_state_dict`` maps a seeded HF-named state dict (with and
  without the ``bert.`` prefix of BertFor*) to the JAX converter's tree,
  bit for bit; ``load_torch_state_dict`` reads pytorch_model.bin (with a
  bf16 tensor among fp32 ones) and model.safetensors to the same arrays.
- ``tools/convert_weights.py``: the port's CLI and the JAX package's write
  identical params.npz, config.json and vocab.txt for an encoder and for
  a token classifier (``--ner``); the converted encoder gives the same
  embeddings in both packages within 1e-5 (fp32 forwards); ``--verify``
  against a transformers BertModel passes on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from rag_icd10_tpu.config import EncoderConfig as JEncoderConfig
from rag_icd10_tpu.models.bert import BertArch as JArch
from rag_icd10_tpu.models.convert_hf import convert_state_dict as jconvert_state_dict
from rag_icd10_tpu.models.encoder import TextEncoder as JEncoder
from rag_icd10_tpu.models.tokenizer import WordPieceTokenizer as JTokenizer
from rag_icd10_tpu.tools.convert_weights import main as jmain
from rag_icd10_tpu_torch.config import EncoderConfig
from rag_icd10_tpu_torch.models.bert import BertArch
from rag_icd10_tpu_torch.models.convert_hf import (
    convert_state_dict,
    load_params,
    load_torch_state_dict,
    params_from_jax,
)
from rag_icd10_tpu_torch.models.encoder import TextEncoder
from rag_icd10_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_icd10_tpu_torch.pipeline.ner_model import TorchTokenClassifier
from rag_icd10_tpu_torch.tools.convert_weights import main

torch.set_num_threads(2)  # the suite runs several test processes at once

H, LAYERS, INTER, VOCAB, POS, LABELS = 32, 2, 64, 48, 32, 5
TEXTS = ["急性胃肠炎", "高血压病3级，2型糖尿病", "疑似急性心肌梗死",
         "慢性阻塞性肺疾病急性加重期伴呼吸衰竭"]


def hf_state_dict(seed=0, prefix="", head=False):
    """An HF BertModel-named state dict of seeded numpy arrays."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.2)

    sd = {
        "embeddings.word_embeddings.weight": a(VOCAB, H),
        "embeddings.position_embeddings.weight": a(POS, H),
        "embeddings.token_type_embeddings.weight": a(2, H),
        "embeddings.LayerNorm.weight": 1 + a(H),
        "embeddings.LayerNorm.bias": a(H),
        "embeddings.position_ids": np.arange(POS, dtype=np.int64)[None, :],
    }
    for i in range(LAYERS):
        p = f"encoder.layer.{i}"
        for name, (n_out, n_in) in {
            "attention.self.query": (H, H), "attention.self.key": (H, H),
            "attention.self.value": (H, H), "attention.output.dense": (H, H),
            "intermediate.dense": (INTER, H), "output.dense": (H, INTER),
        }.items():
            sd[f"{p}.{name}.weight"] = a(n_out, n_in)
            sd[f"{p}.{name}.bias"] = a(n_out)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{p}.{name}.weight"] = 1 + a(H)
            sd[f"{p}.{name}.bias"] = a(H)
    sd = {prefix + k: v for k, v in sd.items()}
    if head:
        sd["classifier.weight"] = a(LABELS, H)
        sd["classifier.bias"] = a(LABELS)
    return sd


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("prefix", ["", "bert."])
def test_convert_state_dict_matches_jax(prefix):
    sd = hf_state_dict(prefix=prefix, head=bool(prefix))
    jarch = JArch(vocab_size=VOCAB, hidden_size=H, num_layers=LAYERS, num_heads=2,
                  intermediate_size=INTER, max_position_embeddings=POS)
    arch = BertArch(vocab_size=VOCAB, hidden_size=H, num_layers=LAYERS, num_heads=2,
                    intermediate_size=INTER, max_position_embeddings=POS)
    got, want = _flat(convert_state_dict(sd, arch)), _flat(jconvert_state_dict(sd, jarch))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # and the tree loads into the port's module: every Dense transposed back
    state = params_from_jax(convert_state_dict(sd, arch))
    src = "bert." if prefix else ""
    np.testing.assert_array_equal(
        state["bert.layers.1.intermediate.weight"].numpy(),
        sd[f"{src}encoder.layer.1.intermediate.dense.weight"])


def test_load_torch_state_dict_bin_and_safetensors(tmp_path):
    sd = hf_state_dict(seed=1)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    tensors["extra.half"] = torch.ones(3, dtype=torch.bfloat16)  # no numpy dtype
    torch.save(tensors, tmp_path / "pytorch_model.bin")
    got = load_torch_state_dict(str(tmp_path))
    for key, want in sd.items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert got["extra.half"].dtype == np.float32 and (got["extra.half"] == 1).all()
    safetensors = pytest.importorskip("safetensors.numpy")
    st = tmp_path / "st"
    st.mkdir()
    safetensors.save_file(sd, str(st / "model.safetensors"))
    got = load_torch_state_dict(str(st))
    for key, want in sd.items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    with pytest.raises(FileNotFoundError):
        load_torch_state_dict(str(tmp_path / "none"))


def _hf_dir(root, head=False):
    root.mkdir()
    tok = WordPieceTokenizer.from_corpus(TEXTS)
    assert tok.vocab_size <= VOCAB
    tok.save_vocab(str(root / "vocab.txt"))
    config = {"vocab_size": VOCAB, "hidden_size": H, "num_hidden_layers": LAYERS,
              "num_attention_heads": 2, "intermediate_size": INTER,
              "max_position_embeddings": POS}
    if head:
        config["id2label"] = {str(i): f"L{i}" for i in range(LABELS)}
    (root / "config.json").write_text(json.dumps(config))
    sd = hf_state_dict(seed=2, prefix="bert." if head else "", head=head)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, root / "pytorch_model.bin")
    return root


def _same_outputs(out, jout):
    got, want = np.load(out / "params.npz"), np.load(jout / "params.npz")
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for name in ("config.json", "vocab.txt"):
        assert (out / name).read_text() == (jout / name).read_text()


def test_cli_encoder_round_trip(tmp_path, capsys):
    src = _hf_dir(tmp_path / "hf")
    out, jout = tmp_path / "port", tmp_path / "jax"
    assert main(["--model-dir", str(src), "--out", str(out)]) == 0
    assert f"EMBEDDING_WEIGHTS_PATH={out}/params.npz" in capsys.readouterr().out
    assert jmain(["--model-dir", str(src), "--out", str(jout)]) == 0
    _same_outputs(out, jout)
    kw = dict(hidden_size=H, num_layers=LAYERS, num_heads=2, intermediate_size=INTER,
              vocab_size=VOCAB, max_position_embeddings=POS, dtype="float32",
              max_length=POS, length_buckets=(16, 32),
              weights_path=str(out / "params.npz"), vocab_path=str(out / "vocab.txt"))
    enc = TextEncoder(EncoderConfig(**kw), device="cpu")
    jenc = JEncoder(JEncoderConfig(**kw),
                    tokenizer=JTokenizer.from_vocab_file(str(out / "vocab.txt")))
    np.testing.assert_allclose(enc.encode_queries(TEXTS), jenc.encode_queries(TEXTS),
                               atol=1e-5)


def test_cli_ner_round_trip(tmp_path, capsys):
    src = _hf_dir(tmp_path / "hf", head=True)
    out, jout = tmp_path / "port", tmp_path / "jax"
    assert main(["--model-dir", str(src), "--out", str(out), "--ner"]) == 0
    assert f"NER_WEIGHTS_PATH={out}" in capsys.readouterr().out
    assert jmain(["--model-dir", str(src), "--out", str(jout), "--ner"]) == 0
    _same_outputs(out, jout)
    clf = TorchTokenClassifier.from_weights(str(out), device="cpu",
                                            compute_dtype=torch.float32)
    sd = hf_state_dict(seed=2, prefix="bert.", head=True)
    np.testing.assert_array_equal(clf.model.classifier.weight.detach().numpy(),
                                  sd["classifier.weight"])
    assert load_params(str(out / "params.npz"))["classifier"]["kernel"].shape == (H, LABELS)


def test_cli_verify_against_transformers(tmp_path):
    transformers = pytest.importorskip("transformers")
    chars = sorted(set("".join(TEXTS)))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars
    src = tmp_path / "hf"
    src.mkdir()
    (src / "vocab.txt").write_text("\n".join(vocab), encoding="utf-8")
    cfg = transformers.BertConfig(
        vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, max_position_embeddings=64,
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0,
    )
    torch.manual_seed(0)
    transformers.BertModel(cfg).eval().save_pretrained(str(src))
    out = tmp_path / "converted"
    assert main(["--model-dir", str(src), "--out", str(out), "--verify",
                 "--device", "cpu"]) == 0
