"""The encoder's model families (models/family.py): the one seam through
which the training tool and step reach a model.

- Neither ``tools/train_encoder.py`` nor ``parallel/train.py`` names a
  family other than through the seam (parsed with ``ast``, as
  tests/test_torch_import_boundary.py reads the port's imports).
- Each family's checkpoint comes back bit for bit: save, look the family
  up by the ``model_type`` beside it, load, ``init_train_state``,
  ``params()``.
- The lookup keeps the rule: no ``config.json``, or one without
  ``model_type``, or ``"bert"``, is BERT; ``"deepseek_v3"``,
  ``"kimi_linear"`` and ``"xing4_0"`` the decoders; any other
  ``model_type`` raises ``ValueError`` naming the known ones.
- Moonlight's and Kimi-Linear's decoders, which share the block that
  Xing4.0 extends (q-LoRA, YaRN), keep their parameter names and, on the
  CPU, their outputs and gradients as the code before Xing4.0 gave them.
"""

import ast
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rag_icd10_tpu_torch.config import EncoderConfig
from rag_icd10_tpu_torch.models import deepseek_v3 as dv
from rag_icd10_tpu_torch.models import family as model_family
from rag_icd10_tpu_torch.models import kimi_linear as kl
from rag_icd10_tpu_torch.models import xing4 as xg
from rag_icd10_tpu_torch.models.bert import BertArch
from rag_icd10_tpu_torch.parallel.train import init_train_state
from rag_icd10_tpu_torch.utils.metrics import metrics

torch.set_num_threads(2)  # the suite runs several test processes at once

ROOT = Path(__file__).resolve().parents[1]
SEAM_USERS = ("rag_icd10_tpu_torch/tools/train_encoder.py",
              "rag_icd10_tpu_torch/parallel/train.py")
DECODER_MODULES = ("deepseek_v3", "kimi_linear", "xing4")
DECODER_NAMES = {"DeepseekV3Arch", "KimiLinearArch", "Xing4Arch", "MODEL_TYPE", "xing4_0",
                 *DECODER_MODULES}

WIDTHS = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
              max_position_embeddings=16)
BERT_TINY = BertArch(**WIDTHS)
DECODER_SMALL = dict(
    model_type="deepseek_v3", vocab_size=80, hidden_size=32, intermediate_size=64,
    moe_intermediate_size=16, num_hidden_layers=2, num_attention_heads=2, kv_lora_rank=16,
    q_lora_rank=None, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
    n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1, first_k_dense_replace=1,
    max_position_embeddings=32, experts_held=[2, 3, 4])
KIMI_SMALL = dict(
    model_type="kimi_linear", vocab_size=80, hidden_size=32, intermediate_size=64,
    moe_intermediate_size=16, num_hidden_layers=2, num_attention_heads=2, kv_lora_rank=16,
    q_lora_rank=None, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, num_experts=8,
    num_experts_per_token=2, num_shared_experts=1, first_k_dense_replace=1, mla_use_nope=True,
    linear_attn_config=dict(kda_layers=[1], full_attn_layers=[2], head_dim=8, num_heads=2,
                            short_conv_kernel_size=4), experts_held=[2, 3, 4])
XING_SMALL = dict(
    DECODER_SMALL, model_type="xing4_0", q_lora_rank=16, hc_mult=4, hc_sinkhorn_iters=20,
    hc_eps=1e-6, mhc_h_res_clamp_min=-30, mhc_h_res_clamp_max=30, rope_theta=10000,
    rope_scaling=dict(type="yarn", factor=64, original_max_position_embeddings=4096,
                      beta_fast=32, beta_slow=1, mscale=1, mscale_all_dim=1))


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
            if any(m.split(".")[-1] in DECODER_MODULES for m in modules):
                found.append(f"{node.lineno}: from {node.module} import ...")
        elif isinstance(node, ast.Import):
            found += [f"{node.lineno}: import {a.name}" for a in node.names
                      if set(DECODER_MODULES) & set(a.name.split("."))]
        elif isinstance(node, ast.Name) and node.id in DECODER_NAMES:
            found.append(f"{node.lineno}: {node.id}")
        elif isinstance(node, ast.Attribute) and node.attr in DECODER_NAMES:
            found.append(f"{node.lineno}: .{node.attr}")
        elif isinstance(node, ast.Constant) and node.value in DECODER_MODULES:
            found.append(f"{node.lineno}: {node.value!r}")
    assert not found, f"{path} names the decoder: {found}"


def _bert_case():
    return BERT_TINY, model_family.BERT.init_params(BERT_TINY, seed=4), _flat


def _decoder_case(module=dv, arch_type=dv.DeepseekV3Arch, config=DECODER_SMALL):
    arch = arch_type.from_config(config)
    params = module.init_params(arch, seed=4)
    rng = np.random.default_rng(5)
    for k, v in params.items():  # biases and norms away from their init
        if v.ndim == 1:
            params[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
    return arch, params, dict


def _kimi_case():
    return _decoder_case(kl, kl.KimiLinearArch, KIMI_SMALL)


def _xing_case():
    return _decoder_case(xg, xg.Xing4Arch, XING_SMALL)


@pytest.mark.parametrize("model_type,case", [("bert", _bert_case),
                                             ("deepseek_v3", _decoder_case),
                                             ("kimi_linear", _kimi_case),
                                             ("xing4_0", _xing_case)])
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
    ({"model_type": "bert"}, "bert"), (DECODER_SMALL, "deepseek_v3"),
    (KIMI_SMALL, "kimi_linear"), (XING_SMALL, "xing4_0")])
def test_lookup_keeps_the_rule(tmp_path, config, model_type):
    if config is not None:
        (tmp_path / "config.json").write_text(json.dumps(config))
    fam, read = model_family.beside(str(tmp_path / "params.npz"))
    assert fam.model_type == model_type and read == (config or {})


def test_no_checkpoint_is_bert():
    assert model_family.beside(None) == (model_family.BERT, {})


def test_an_unclaimed_model_type_names_the_known_ones(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "llama"}))
    with pytest.raises(ValueError, match="'llama'.*bert, deepseek_v3, kimi_linear, xing4_0"):
        model_family.beside(str(tmp_path / "params.npz"))


def test_capabilities():
    bert, decoder = model_family.FAMILIES["bert"], model_family.FAMILIES["deepseek_v3"]
    assert bert.served and bert.mesh
    assert not decoder.served and not decoder.mesh
    assert model_family.of_arch(dv.DeepseekV3Arch()) is decoder
    kimi = model_family.FAMILIES["kimi_linear"]
    assert not kimi.served and not kimi.mesh
    assert model_family.of_arch(kl.KimiLinearArch()) is kimi
    xing = model_family.FAMILIES["xing4_0"]
    assert not xing.served and not xing.mesh
    assert model_family.of_arch(xg.Xing4Arch()) is xing  # its own, not its base's
    assert bert.log_text == "" and bert.log_values(bert.log_reading(), None, 1) == []


def test_decoder_log_values_are_the_interval_s():
    held = np.array([0, 0, 3, 1, 0, 0, 0, 0])  # 8 experts; 4 slots of 10 routed went here
    before = ({"moe.held_slots.1": np.zeros(8), "moe.routed_slots.1": np.asarray(0)}, 7, 16)
    after = ({"moe.held_slots.1": held, "moe.routed_slots.1": np.asarray(10)}, 27, 80)
    decoder = model_family.FAMILIES["deepseek_v3"]
    share, load, calls, norm_calls = decoder.log_values(before, after, 4)
    assert share == 40.0 and load == 3 / 0.5 and calls == 5.0 and norm_calls == 16.0
    assert decoder.log_text % (share, load, calls, norm_calls) == (
        "; experts held 40.0% of slots, load max/mean 6.00; MLA kernel 5.0 calls a step; "
        "norm kernel 16.0 calls a step")


def test_kimi_log_values_are_the_interval_s():
    """The Kimi decoder's --log-every fields: the experts' held share and
    max/mean, then the delta-rule core's calls and those through its
    kernel, the MLA kernel's and the norm kernel's calls a step."""
    held = np.array([0, 0, 3, 1, 0, 0, 0, 0])
    before = ({"moe.held_slots.1": np.zeros(8), "moe.routed_slots.1": np.asarray(0)}, 8, 0, 7,
              16)
    after = ({"moe.held_slots.1": held, "moe.routed_slots.1": np.asarray(10)}, 40, 32, 15, 112)
    kimi = model_family.FAMILIES["kimi_linear"]
    values = kimi.log_values(before, after, 4)
    assert values == [40.0, 3 / 0.5, 8.0, 8.0, 2.0, 24.0]
    assert kimi.log_text % tuple(values) == (
        "; experts held 40.0% of slots, load max/mean 6.00; KDA core 8.0 calls a step, "
        "kernel 8.0; MLA kernel 2.0 calls a step; norm kernel 24.0 calls a step")


def test_xing_log_values_are_the_interval_s():
    """The Xing4.0 decoder's --log-every fields: the experts' held share and
    max/mean, then the hyper-connections' pre calls, the MLA kernel's and
    the norm kernel's calls a step."""
    held = np.array([0, 0, 3, 1, 0, 0, 0, 0])
    before = ({"moe.held_slots.2": np.zeros(8), "moe.routed_slots.2": np.asarray(0)}, 24, 0, 50)
    after = ({"moe.held_slots.2": held, "moe.routed_slots.2": np.asarray(10)}, 120, 48, 250)
    xing = model_family.FAMILIES["xing4_0"]
    values = xing.log_values(before, after, 4)
    assert values == [40.0, 3 / 0.5, 24.0, 12.0, 50.0]
    assert xing.log_text % tuple(values) == (
        "; experts held 40.0% of slots, load max/mean 6.00; mHC 24.0 calls a step; MLA kernel "
        "12.0 calls a step; norm kernel 50.0 calls a step")


# The small decoders' parameter names (a digest of them in order, and their
# number), their first 4 embedding columns and the gradient norm of a fixed
# weighting of the embeddings, fp32 on the CPU, as the code before Xing4.0's
# q-LoRA and YaRN gave them. Outputs within 1e-6 and the gradient norm within
# 1e-5 (relative): sums in another order on another machine, nothing more.
BEFORE = {
    "deepseek_v3": ("b2fab88d848a1c91", 33, [
        [0.16866792738437653, -0.2815770208835602, 0.3328549265861511, -0.009972206316888332],
        [0.2432565987110138, -0.4039247930049896, 0.23048311471939087, -0.016736825928092003],
        [0.37784644961357117, -0.16947945952415466, -0.32432278990745544, 0.037273064255714417]],
        22.332936393625616),
    "kimi_linear": ("8dc3c5faa41f5d6c", 44, [
        [0.10742710530757904, -0.2225232869386673, -0.1517614871263504, -0.25058606266975403],
        [0.03082793578505516, -0.23762927949428558, -0.2725082039833069, 0.2339450716972351],
        [0.22507230937480927, -0.01047072559595108, -0.26405203342437744, 0.08778925240039825]],
        27.804897165101718),
}


@pytest.mark.parametrize("model_type", list(BEFORE))
def test_moonlight_and_kimi_decoders_are_unchanged(model_type):
    metrics.reset()  # the expert layers' counters, of other shapes in other tests
    module, arch_type, config, sentence = {
        "deepseek_v3": (dv, dv.DeepseekV3Arch, DECODER_SMALL, dv.SentenceDeepseekV3),
        "kimi_linear": (kl, kl.KimiLinearArch, KIMI_SMALL, kl.SentenceKimiLinear)}[model_type]
    arch = arch_type.from_config(config, compute_dtype=torch.float32)
    params = module.init_params(arch, seed=4)
    model = sentence(arch)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    gen = torch.Generator().manual_seed(6)
    ids = torch.randint(1, 80, (3, 11), generator=gen)
    mask = torch.ones_like(ids)
    mask[1, 7:] = 0
    z = model(ids, mask)
    (z * torch.linspace(-1, 1, z.numel()).view(z.shape)).sum().backward()
    digest, count, columns, grad = BEFORE[model_type]
    assert (hashlib.sha256("\n".join(params).encode()).hexdigest()[:16], len(params)) == \
        (digest, count)
    np.testing.assert_allclose(z.detach()[:, :4].numpy(), np.array(columns), rtol=0, atol=1e-6)
    norm = float(sum(p.grad.double().norm() ** 2 for p in model.parameters()) ** 0.5)
    assert norm == pytest.approx(grad, rel=1e-5)
