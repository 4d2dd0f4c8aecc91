"""The encoder's model families (models/family.py): the one seam through
which the training tool and step reach a model.

- Neither ``tools/train_encoder.py`` nor ``parallel/train.py`` names a
  family other than through the seam (parsed with ``ast``, as
  tests/test_torch_import_boundary.py reads the port's imports).
- Each family's checkpoint comes back bit for bit: save, look the family
  up by the ``model_type`` beside it, load, ``init_train_state``,
  ``params()``.
- The lookup keeps the rule: no ``config.json``, or one without
  ``model_type``, or ``"bert"``, is BERT; ``"deepseek_v3"`` the decoder;
  any other ``model_type`` raises ``ValueError`` naming the known ones.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rag_icd10_tpu_torch.config import EncoderConfig
from rag_icd10_tpu_torch.models import deepseek_v3 as dv
from rag_icd10_tpu_torch.models import family as model_family
from rag_icd10_tpu_torch.models.bert import BertArch
from rag_icd10_tpu_torch.parallel.train import init_train_state

torch.set_num_threads(2)  # the suite runs several test processes at once

ROOT = Path(__file__).resolve().parents[1]
SEAM_USERS = ("rag_icd10_tpu_torch/tools/train_encoder.py",
              "rag_icd10_tpu_torch/parallel/train.py")
DECODER_NAMES = {"DeepseekV3Arch", "MODEL_TYPE", "deepseek_v3"}

WIDTHS = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
              max_position_embeddings=16)
BERT_TINY = BertArch(**WIDTHS)
DECODER_SMALL = dict(
    model_type="deepseek_v3", vocab_size=80, hidden_size=32, intermediate_size=64,
    moe_intermediate_size=16, num_hidden_layers=2, num_attention_heads=2, kv_lora_rank=16,
    q_lora_rank=None, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
    n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1, first_k_dense_replace=1,
    max_position_embeddings=32, experts_held=[2, 3, 4])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("path", SEAM_USERS)
def test_tool_and_step_name_no_family_but_through_the_seam(path):
    tree = ast.parse((ROOT / path).read_text())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            modules = [node.module or ""] + [f"{node.module or ''}.{a.name}" for a in node.names]
            if any(m.split(".")[-1] == "deepseek_v3" for m in modules):
                found.append(f"{node.lineno}: from {node.module} import ...")
        elif isinstance(node, ast.Import):
            found += [f"{node.lineno}: import {a.name}" for a in node.names
                      if "deepseek_v3" in a.name.split(".")]
        elif isinstance(node, ast.Name) and node.id in DECODER_NAMES:
            found.append(f"{node.lineno}: {node.id}")
        elif isinstance(node, ast.Attribute) and node.attr in DECODER_NAMES:
            found.append(f"{node.lineno}: .{node.attr}")
        elif isinstance(node, ast.Constant) and node.value == "deepseek_v3":
            found.append(f"{node.lineno}: {node.value!r}")
    assert not found, f"{path} names the decoder: {found}"


def _bert_case():
    return BERT_TINY, model_family.BERT.init_params(BERT_TINY, seed=4), _flat


def _decoder_case():
    arch = dv.DeepseekV3Arch.from_config(DECODER_SMALL)
    params = dv.init_params(arch, seed=4)
    rng = np.random.default_rng(5)
    for k, v in params.items():  # biases and norms away from their init
        if v.ndim == 1:
            params[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
    return arch, params, dict


@pytest.mark.parametrize("model_type,case", [("bert", _bert_case),
                                             ("deepseek_v3", _decoder_case)])
def test_checkpoint_round_trip_through_the_seam(tmp_path, model_type, case):
    arch, params, flat = case()
    path = str(tmp_path / "ckpt" / "params.npz")
    (tmp_path / "ckpt").mkdir()
    fam = model_family.of_arch(arch)
    assert fam.model_type == model_type
    fam.save(params, arch, path)
    found, config = model_family.beside(path)
    assert found is fam
    again = found.arch(config, EncoderConfig(**WIDTHS), 40)
    assert again == arch
    assert config.get("model_type", "bert") == model_type
    loaded = found.load(path, again)
    state = init_train_state(again, params=loaded, device="cpu")
    assert state.family is fam
    want, got = flat(params), flat(state.params())
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("config,model_type", [
    (None, "bert"), ({}, "bert"), ({"hidden_size": 768}, "bert"),
    ({"model_type": "bert"}, "bert"), (DECODER_SMALL, "deepseek_v3")])
def test_lookup_keeps_the_rule(tmp_path, config, model_type):
    if config is not None:
        (tmp_path / "config.json").write_text(json.dumps(config))
    fam, read = model_family.beside(str(tmp_path / "params.npz"))
    assert fam.model_type == model_type and read == (config or {})


def test_no_checkpoint_is_bert():
    assert model_family.beside(None) == (model_family.BERT, {})


def test_an_unclaimed_model_type_names_the_known_ones(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "llama"}))
    with pytest.raises(ValueError, match="'llama'.*bert, deepseek_v3"):
        model_family.beside(str(tmp_path / "params.npz"))


def test_capabilities():
    bert, decoder = model_family.FAMILIES["bert"], model_family.FAMILIES["deepseek_v3"]
    assert bert.served and bert.mesh
    assert not decoder.served and not decoder.mesh
    assert model_family.of_arch(dv.DeepseekV3Arch()) is decoder
    assert bert.log_text == "" and bert.log_values(bert.log_reading(), None, 1) == []


def test_decoder_log_values_are_the_interval_s():
    held = np.array([0, 0, 3, 1, 0, 0, 0, 0])  # 8 experts; 4 slots of 10 routed went here
    before = ({"moe.held_slots.1": np.zeros(8), "moe.routed_slots.1": np.asarray(0)}, 7)
    after = ({"moe.held_slots.1": held, "moe.routed_slots.1": np.asarray(10)}, 27)
    decoder = model_family.FAMILIES["deepseek_v3"]
    share, load, calls = decoder.log_values(before, after, 4)
    assert share == 40.0 and load == 3 / 0.5 and calls == 5.0
    assert decoder.log_text % (share, load, calls) == (
        "; experts held 40.0% of slots, load max/mean 6.00; MLA kernel 5.0 calls a step")
