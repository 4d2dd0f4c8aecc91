"""The encoder's model families, by the ``model_type`` of the ``config.json``
beside a checkpoint (the key the benchmark's ``perfbench/families/`` uses);
none, or none named, is BERT. A family holds what the training tool and
step would otherwise decide by model: a new one is a model module and an
entry of ``FAMILIES``."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.metrics import metrics
from . import deepseek_v3 as dv
from . import kimi_linear as kl
from . import xing4 as xg
from .bert import BertArch, SentenceBert, init_params
from .convert_hf import jax_leaf_order, load_params, params_from_jax, params_to_jax, save_params


@dataclasses.dataclass(frozen=True)
class Family:
    model_type: str
    arch_type: type
    served: bool  # models/encoder.py embeds with it: --eval-gate, the EMBEDDING_* exports
    mesh: bool  # trains over a dp/tp mesh
    arch: Callable  # (config.json, config.EncoderConfig, vocabulary ids) -> arch
    init_params: Callable  # (arch, seed=) -> params
    module: Callable  # arch -> the model, fp32 masters, on the current device
    state_dict: Callable  # params -> the model's state dict
    params_of: Callable  # model -> params, as the checkpoint lays them out
    leaf_order: Callable  # model -> (parameters() index, transposed) of each optimizer leaf
    load: Callable  # (path, arch) -> params
    save: Callable  # (params, arch, path)
    log_text: str = ""  # the --log-every line's own fields: log_values of two log_readings
    log_reading: Callable = lambda: None
    log_values: Callable = lambda before, after, steps: []


BERT = Family(
    "bert", BertArch, served=True, mesh=True,
    arch=lambda config, e, vocab_size: BertArch(
        vocab_size=max(e.vocab_size, vocab_size), hidden_size=e.hidden_size,
        num_layers=e.num_layers, num_heads=e.num_heads, intermediate_size=e.intermediate_size,
        max_position_embeddings=e.max_position_embeddings),
    init_params=init_params,
    module=lambda arch: SentenceBert(dataclasses.replace(arch, param_dtype=torch.float32)),
    state_dict=params_from_jax, params_of=lambda model: params_to_jax(model.state_dict()),
    leaf_order=jax_leaf_order, load=lambda path, arch: load_params(path),
    save=lambda params, arch, path: save_params(params, path))


def _per_step(before, after, steps):
    """The experts' held share and max/mean between two readings
    (``metrics.counters("moe.")`` first), then each host counter's rise a
    step."""
    return [*dv.moe_load(before[0], after[0]),
            *((a - b) / steps for a, b in zip(after[1:], before[1:]))]


def _decoder(module, arch_type, sentence, log_text, log_reading) -> Family:
    """A decoder family: one device, not served, the model ``sentence``, its
    checkpoint one ``.npz`` in the published names (``module``'s
    ``init_params``, ``load_weights``, ``save_weights``)."""
    return Family(
        module.MODEL_TYPE, arch_type, served=False, mesh=False,
        arch=lambda config, e, vocab_size: arch_type.from_config(config),
        init_params=module.init_params, module=sentence,
        state_dict=lambda params: {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()},
        params_of=lambda model: {k: t.detach().to("cpu", torch.float32).numpy()
                                 for k, t in model.state_dict().items()},
        leaf_order=lambda model: [(i, False) for i, _ in enumerate(model.parameters())],
        load=module.load_weights, save=module.save_weights, log_text=log_text,
        log_reading=log_reading, log_values=_per_step)


EXPERTS_TEXT = "; experts held %.1f%% of slots, load max/mean %.2f"
KERNELS_TEXT = "; MLA kernel %.1f calls a step; norm kernel %.1f calls a step"

FAMILIES: Dict[str, Family] = {f.model_type: f for f in (
    BERT,
    _decoder(dv, dv.DeepseekV3Arch, dv.SentenceDeepseekV3, EXPERTS_TEXT + KERNELS_TEXT,
             lambda: (metrics.counters("moe."), dv.mla_kernel_calls(),  # waits for the device
                      dv.norm_kernel_calls())),
    _decoder(kl, kl.KimiLinearArch, kl.SentenceKimiLinear,
             EXPERTS_TEXT + "; KDA core %.1f calls a step, kernel %.1f" + KERNELS_TEXT,
             lambda: (metrics.counters("moe."), kl.kda_core_calls(), kl.kda_kernel_calls(),
                      dv.mla_kernel_calls(), dv.norm_kernel_calls())),
    _decoder(xg, xg.Xing4Arch, xg.SentenceXing4,
             EXPERTS_TEXT + "; mHC %.1f calls a step" + KERNELS_TEXT,
             lambda: (metrics.counters("moe."), xg.mhc_calls(), dv.mla_kernel_calls(),
                      dv.norm_kernel_calls())),
)}


def beside(path: Optional[str]) -> Tuple[Family, Dict]:
    """The family of checkpoint ``path`` and the ``config.json`` beside it
    ({} where there is none), read once."""
    config = Path(path).parent / "config.json" if path else None
    cfg = json.loads(config.read_text()) if config is not None and config.exists() else {}
    model_type = cfg.get("model_type", BERT.model_type)
    if model_type not in FAMILIES:
        raise ValueError(f"model_type {model_type!r}: no encoder family (known: "
                         f"{', '.join(sorted(FAMILIES))})")
    return FAMILIES[model_type], cfg


def of_arch(arch) -> Family:
    """The family whose arch type is ``arch``'s own (not a base of it)."""
    return next(f for f in FAMILIES.values() if type(arch) is f.arch_type)
