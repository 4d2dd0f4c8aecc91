"""Encoder weights: the JAX package's parameter tree <-> PyTorch state dict.

Both packages persist encoder weights as one flat ``.npz`` whose keys are
the parameter-tree paths joined with '/' (rag_icd10_tpu/models/
convert_hf.py:90-116), so a weights file written for one loads in the
other. ``params_from_jax`` carries such a tree (numpy arrays, or the JAX
package's own arrays) into ``SentenceBert``'s state dict: flax ``Dense``
kernels are stored (in, out) and are transposed to ``nn.Linear``'s
(out, in); embeddings and LayerNorm ``scale``/``bias`` are renamed.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch


def save_params(params: Dict, path: str) -> None:
    """Persist a param tree as a flat npz (keys joined with '/')."""
    flat: Dict[str, np.ndarray] = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(params)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_params(path: str) -> Dict:
    flat = np.load(path)
    tree: Dict = {}
    for key in flat.files:
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return tree


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX-layout param tree ({"bert": {...}}) -> ``SentenceBert`` state
    dict of fp32 tensors."""
    bert = params["bert"]

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def dense(tree, prefix):
        return {
            f"{prefix}.weight": t(tree["kernel"]).T.contiguous(),
            f"{prefix}.bias": t(tree["bias"]),
        }

    def ln(tree, prefix):
        return {f"{prefix}.weight": t(tree["scale"]), f"{prefix}.bias": t(tree["bias"])}

    sd: Dict[str, torch.Tensor] = {
        "bert.word_embeddings.weight": t(bert["word_embeddings"]["embedding"]),
        "bert.position_embeddings.weight": t(bert["position_embeddings"]["embedding"]),
        "bert.token_type_embeddings.weight": t(bert["token_type_embeddings"]["embedding"]),
        **ln(bert["embeddings_ln"], "bert.embeddings_ln"),
    }
    num_layers = sum(1 for key in bert if key.startswith("layer_"))
    for i in range(num_layers):
        layer, p = bert[f"layer_{i}"], f"bert.layers.{i}"
        for name in ("query", "key", "value", "out"):
            sd.update(dense(layer["attention"][name], f"{p}.attention.{name}"))
        sd.update(ln(layer["attention_ln"], f"{p}.attention_ln"))
        sd.update(dense(layer["intermediate"], f"{p}.intermediate"))
        sd.update(dense(layer["output"], f"{p}.output"))
        sd.update(ln(layer["output_ln"], f"{p}.output_ln"))
    return sd
