"""BERT weights made on the device from the seed.

One ``torch.Generator`` on the device fills one flat fp32 buffer in a few
large calls; the leaves are views of it. Laws as the port's seeded init:
Dense kernels std 1/sqrt(fan_in), embeddings std 1/sqrt(hidden), LayerNorm
scale 1, every bias 0. Names and shapes are the benchmark's own: Dense
kernels are (in, out).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import WEIGHTS, torch_seed


def leaf_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, law) of every leaf; law is "normal:<std>", "one" or
    "zero"."""
    h, inter, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    emb = f"normal:{1.0 / math.sqrt(h)}"
    out = [("word", (v, h), emb), ("pos", (cfg["max_position_embeddings"], h), emb),
           ("type", (cfg["type_vocab_size"], h), emb),
           ("emb_ln.g", (h,), "one"), ("emb_ln.b", (h,), "zero")]
    for i in range(cfg["num_hidden_layers"]):
        for name, n_in, n_out in (("q", h, h), ("k", h, h), ("v", h, h), ("o", h, h),
                                  ("ffn_in", h, inter), ("ffn_out", inter, h)):
            out.append((f"l{i}.{name}.w", (n_in, n_out), f"normal:{1.0 / math.sqrt(n_in)}"))
            out.append((f"l{i}.{name}.b", (n_out,), "zero"))
        for ln in ("attn_ln", "out_ln"):
            out += [(f"l{i}.{ln}.g", (h,), "one"), (f"l{i}.{ln}.b", (h,), "zero")]
    return out


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf as an fp32 view of one buffer on ``device``."""
    leaves = leaf_shapes(cfg)
    total = sum(int(np.prod(s)) for _, s, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, WEIGHTS))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, law in leaves:
        n = int(np.prod(shape))
        x = flat[at:at + n].view(shape)
        if law == "one":
            x.fill_(1.0)
        elif law == "zero":
            x.zero_()
        else:
            x.mul_(float(law.split(":")[1]))
        out[name] = x
        at += n
    return out


def to_host(w: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``make_weights``'s leaves as views of one host copy of its buffer."""
    flat = next(iter(w.values()))._base
    host, base = flat.cpu().numpy(), flat.data_ptr()
    return {k: host[(v.data_ptr() - base) // 4:][: v.numel()].reshape(v.shape)
            for k, v in w.items()}


def jax_layout(w: Dict[str, np.ndarray], cfg: Dict) -> Dict:
    """The port's weight files' parameter tree (``{"bert": {...}}``, Dense
    ``kernel`` (in, out)) over host arrays of ``w``."""
    def dense(p):
        return {"kernel": w[p + ".w"], "bias": w[p + ".b"]}

    def ln(p):
        return {"scale": w[p + ".g"], "bias": w[p + ".b"]}

    bert = {"word_embeddings": {"embedding": w["word"]},
            "position_embeddings": {"embedding": w["pos"]},
            "token_type_embeddings": {"embedding": w["type"]},
            "embeddings_ln": ln("emb_ln")}
    for i in range(cfg["num_hidden_layers"]):
        p = f"l{i}"
        bert[f"layer_{i}"] = {
            "attention": {"query": dense(p + ".q"), "key": dense(p + ".k"),
                          "value": dense(p + ".v"), "out": dense(p + ".o")},
            "attention_ln": ln(p + ".attn_ln"),
            "intermediate": dense(p + ".ffn_in"),
            "output": dense(p + ".ffn_out"),
            "output_ln": ln(p + ".out_ln"),
        }
    return {"bert": bert}


def save_npz(tree: Dict, path: str) -> None:
    """A parameter tree as a flat ``.npz`` (keys joined with ``/``), the
    layout of the port's ``params.npz``."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = v
    walk(tree, "")
    np.savez(path, **flat)


def port_name(name: str) -> Tuple[str, bool]:
    """The port's state-dict name of a benchmark leaf, and whether the
    port holds it transposed (``nn.Linear`` keeps (out, in))."""
    top = {"word": "bert.word_embeddings.weight", "pos": "bert.position_embeddings.weight",
           "type": "bert.token_type_embeddings.weight",
           "emb_ln.g": "bert.embeddings_ln.weight", "emb_ln.b": "bert.embeddings_ln.bias"}
    if name in top:
        return top[name], False
    layer, part, kind = name.split(".")
    i = int(layer[1:])
    mod = {"q": "attention.query", "k": "attention.key", "v": "attention.value",
           "o": "attention.out", "ffn_in": "intermediate", "ffn_out": "output",
           "attn_ln": "attention_ln", "out_ln": "output_ln"}[part]
    suffix = {"w": "weight", "b": "bias", "g": "weight"}[kind]
    return f"bert.layers.{i}.{mod}.{suffix}", kind == "w"
