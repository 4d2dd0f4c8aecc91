"""BERT weights: HF checkpoints and the JAX package's parameter tree <->
PyTorch state dict.

Both packages persist weights as one flat ``.npz`` whose keys are the
parameter-tree paths joined with '/' (rag_icd10_tpu/models/
convert_hf.py:90-116), so a weights file written for one loads in the
other.

- ``convert_state_dict`` / ``convert_model_dir`` map an HF ``BertModel``
  (or ``BertFor*``) checkpoint to that tree, as the JAX package's
  converter does (:20-88), from a local directory holding
  ``pytorch_model.bin`` or ``model.safetensors``: no network access.
- ``params_from_jax`` carries such a tree (numpy arrays, or the JAX
  package's own arrays) into ``SentenceBert``'s state dict, or a token
  classifier's when the tree has a ``classifier`` head: flax ``Dense``
  kernels are stored (in, out) and are transposed to ``nn.Linear``'s
  (out, in); embeddings and LayerNorm ``scale``/``bias`` are renamed.
  ``params_to_jax`` is its inverse.
- ``opt_state_from_jax`` / ``opt_state_to_jax`` carry the optimizer state
  between the leaves of ``optax.adamw(schedule)`` (the Adam count, ``mu``,
  ``nu`` and the schedule's count, as ``jax.tree_util.tree_leaves``
  flattens them: dict keys sorted at every level) and the ``state`` of
  ``torch.optim.AdamW`` over ``model.parameters()``, so a training
  checkpoint (``params.npz`` + ``opt_state.npz``) of either package
  resumes in the other.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from .bert import BertArch


def arch_from_config(config: Dict, compute_dtype=torch.bfloat16) -> BertArch:
    """BertArch of an HF ``config.json`` (the JAX package's defaults for
    missing keys)."""
    return BertArch(
        vocab_size=config.get("vocab_size", 21128),
        hidden_size=config.get("hidden_size", 768),
        num_layers=config.get("num_hidden_layers", 12),
        num_heads=config.get("num_attention_heads", 12),
        intermediate_size=config.get("intermediate_size", 3072),
        max_position_embeddings=config.get("max_position_embeddings", 512),
        compute_dtype=compute_dtype,
    )


def convert_state_dict(state_dict: Dict[str, np.ndarray], arch: BertArch) -> Dict:
    """Map an HF BertModel state_dict (numpy arrays) to the parameter tree
    ({"bert": {...}}, flax layout)."""

    def npy(key):
        return np.asarray(state_dict[key], dtype=np.float32)

    def dense(prefix):
        return {"kernel": npy(f"{prefix}.weight").T, "bias": npy(f"{prefix}.bias")}

    def ln(prefix):
        return {"scale": npy(f"{prefix}.weight"), "bias": npy(f"{prefix}.bias")}

    # tolerate a leading "bert." (BertModel inside BertForX) prefix
    if not any(k.startswith("embeddings.") for k in state_dict):
        state_dict = {
            k.split(".", 1)[1]: v for k, v in state_dict.items() if "." in k
        }

    bert: Dict = {
        "word_embeddings": {"embedding": npy("embeddings.word_embeddings.weight")},
        "position_embeddings": {
            "embedding": npy("embeddings.position_embeddings.weight")
        },
        "token_type_embeddings": {
            "embedding": npy("embeddings.token_type_embeddings.weight")
        },
        "embeddings_ln": ln("embeddings.LayerNorm"),
    }
    for i in range(arch.num_layers):
        p = f"encoder.layer.{i}"
        bert[f"layer_{i}"] = {
            "attention": {
                "query": dense(f"{p}.attention.self.query"),
                "key": dense(f"{p}.attention.self.key"),
                "value": dense(f"{p}.attention.self.value"),
                "out": dense(f"{p}.attention.output.dense"),
            },
            "attention_ln": ln(f"{p}.attention.output.LayerNorm"),
            "intermediate": dense(f"{p}.intermediate.dense"),
            "output": dense(f"{p}.output.dense"),
            "output_ln": ln(f"{p}.output.LayerNorm"),
        }
    return {"bert": bert}


def load_torch_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    """Read model.safetensors (where the ``safetensors`` package imports)
    or pytorch_model.bin from a local dir, as numpy arrays."""
    d = Path(model_dir)
    st_path = d / "model.safetensors"
    if st_path.exists():
        try:
            from safetensors.numpy import load_file

            return load_file(str(st_path))
        except ImportError:
            pass
    bin_path = d / "pytorch_model.bin"
    if bin_path.exists():
        sd = torch.load(str(bin_path), map_location="cpu", weights_only=True)
        # bf16 has no numpy dtype; every float is read as fp32 anyway
        return {
            k: (v.float() if v.is_floating_point() else v).numpy()
            for k, v in sd.items()
        }
    raise FileNotFoundError(f"no model weights found under {model_dir}")


def convert_model_dir(model_dir: str, arch: BertArch) -> Dict:
    return convert_state_dict(load_torch_state_dict(model_dir), arch)


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
    """JAX-layout param tree ({"bert": {...}}, and a ``classifier`` Dense
    for a token classifier) -> ``SentenceBert`` (or ``TokenClassifier``)
    state dict of fp32 tensors."""
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
    if "classifier" in params:  # flax Dense (H, L) -> nn.Linear (L, H)
        sd.update(dense(params["classifier"], "classifier"))
    return sd


def _param_paths(num_layers: int, classifier: bool = False) -> List[Tuple[tuple, str, bool]]:
    """(JAX tree path, state-dict name, transposed) of every parameter of
    ``SentenceBert`` (and a token classifier's head)."""
    out: List[Tuple[tuple, str, bool]] = []

    def dense(path, name):
        out.extend([(path + ("kernel",), f"{name}.weight", True),
                    (path + ("bias",), f"{name}.bias", False)])

    def ln(path, name):
        out.extend([(path + ("scale",), f"{name}.weight", False),
                    (path + ("bias",), f"{name}.bias", False)])

    for emb in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        out.append((("bert", emb, "embedding"), f"bert.{emb}.weight", False))
    ln(("bert", "embeddings_ln"), "bert.embeddings_ln")
    for i in range(num_layers):
        path, name = ("bert", f"layer_{i}"), f"bert.layers.{i}"
        for proj in ("query", "key", "value", "out"):
            dense(path + ("attention", proj), f"{name}.attention.{proj}")
        ln(path + ("attention_ln",), f"{name}.attention_ln")
        dense(path + ("intermediate",), f"{name}.intermediate")
        dense(path + ("output",), f"{name}.output")
        ln(path + ("output_ln",), f"{name}.output_ln")
    if classifier:
        dense(("classifier",), "classifier")
    return out


def _paths_of(names) -> List[Tuple[tuple, str, bool]]:
    names = set(names)
    num_layers = sum(1 for n in names if n.endswith(".attention.query.weight"))
    return _param_paths(num_layers, classifier="classifier.weight" in names)


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """``SentenceBert`` (or token classifier) state dict -> the JAX-layout
    parameter tree of fp32 numpy arrays, the inverse of
    ``params_from_jax``; ``save_params`` and ``TextEncoder(params=...)``
    take it."""
    tree: Dict = {}
    for path, name, transposed in _paths_of(state_dict):
        x = state_dict[name].detach().to("cpu", torch.float32)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (x.T if transposed else x).contiguous().numpy()
    return tree


def _jax_leaf_order(model) -> List[Tuple[int, bool]]:
    """(index in ``model.parameters()``, transposed) of each parameter in
    the order ``jax.tree_util.tree_leaves`` visits the JAX tree (dict keys
    sorted at every level)."""
    index = {name: i for i, (name, _) in enumerate(model.named_parameters())}
    paths = _paths_of(index)
    if len(paths) != len(index):
        raise ValueError(f"{len(index)} parameters, {len(paths)} known to the JAX layout")
    return [(index[name], transposed) for _, name, transposed in sorted(paths)]


def opt_state_from_jax(leaves, model) -> Dict[int, Dict[str, torch.Tensor]]:
    """Leaves of an ``optax.adamw`` state over the JAX tree of ``model``'s
    parameters ([count, *mu, *nu], then the schedule's count when the
    learning rate is a schedule) -> the ``state`` entry of a
    ``torch.optim.AdamW`` state dict over ``model.parameters()``: per
    parameter ``step`` (the Adam count), ``exp_avg`` (``mu``) and
    ``exp_avg_sq`` (``nu``), kernels transposed to ``nn.Linear``'s
    layout."""
    order = _jax_leaf_order(model)
    count, mu, nu = split_adam_leaves(leaves, len(order))
    step = torch.tensor(float(count), dtype=torch.float32)
    params = list(model.parameters())
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for j, (i, transposed) in enumerate(order):
        moments = []
        for leaf in (mu[j], nu[j]):
            x = torch.from_numpy(np.array(leaf, dtype=np.float32))
            moments.append((x.T if transposed else x).contiguous().to(params[i].device))
        state[i] = {"step": step.clone(), "exp_avg": moments[0], "exp_avg_sq": moments[1]}
    return state


def opt_state_to_jax(optimizer, model) -> List[np.ndarray]:
    """The leaves of the ``optax.adamw(schedule)`` state that ``optimizer``
    (a ``torch.optim.AdamW`` over ``model.parameters()``) holds, in
    ``jax.tree_util.tree_leaves`` order: the count, ``mu``, ``nu`` and the
    schedule's count (equal to the Adam count). Parameters not yet stepped
    have zero moments."""
    order = _jax_leaf_order(model)
    params = list(model.parameters())
    mu, nu, count = [], [], 0
    for i, transposed in order:
        st = optimizer.state.get(params[i], {})
        if "step" in st:
            count = int(float(st["step"]))
        pair = []
        for key in ("exp_avg", "exp_avg_sq"):
            x = st.get(key)
            x = torch.zeros_like(params[i], dtype=torch.float32) if x is None else x
            x = x.detach().to("cpu", torch.float32)
            pair.append((x.T if transposed else x).contiguous().numpy())
        mu.append(pair[0])
        nu.append(pair[1])
    return adam_leaves(count, mu, nu)


def adam_leaves(count: int, mu: List[np.ndarray], nu: List[np.ndarray]) -> List[np.ndarray]:
    """``optax.adamw(schedule)``'s leaves: the Adam count, ``mu`` and
    ``nu`` in the parameter tree's leaf order, the schedule's count."""
    counts = [np.asarray(count, np.int32)]
    return counts + list(mu) + list(nu) + counts


def split_adam_leaves(leaves, n: int) -> Tuple[int, list, list]:
    """(count, mu, nu) of an ``optax.adamw`` state's leaves over ``n``
    parameters, with or without the schedule's count."""
    if len(leaves) not in (2 * n + 1, 2 * n + 2):
        raise ValueError(f"{len(leaves)} optimizer leaves for {n} parameters "
                         f"(expected {2 * n + 1} or {2 * n + 2})")
    return int(np.asarray(leaves[0])), list(leaves[1:1 + n]), list(leaves[1 + n:1 + 2 * n])
