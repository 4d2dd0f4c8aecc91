"""BERT (``model_type`` ``bert``): the post-LayerNorm encoder the port
runs as ``models/bert.py SentenceBert``, handed over as the port's
``params.npz`` (its JAX-layout tree) for ``--init-from ... --params-only``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..gen.weights import jax_layout, make_weights, port_name, save_npz, to_host
from ..reference.bert import encode_tokens
from ..reference.train import loss_fn
from ..roofline import train_step_flops as step_flops

__all__ = ["start_leaves", "hand_over", "program_config", "port_name", "loss", "step_flops"]


def start_leaves(cfg: Dict, seed: int, device) -> Dict[str, np.ndarray]:
    return to_host(make_weights(cfg, seed, device))


def hand_over(cfg: Dict, w0: Dict[str, np.ndarray], init: Path) -> List[str]:
    save_npz(jax_layout(w0, cfg), str(init / "params.npz"))
    return ["--init-from", str(init / "params.npz"), "--params-only"]


def program_config(cfg: Dict, pc):
    enc = dataclasses.replace(
        pc.encoder, hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], intermediate_size=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"], layer_norm_eps=cfg["layer_norm_eps"])
    return pc if enc == pc.encoder else dataclasses.replace(pc, encoder=enc)


def loss(cfg: Dict, w, batch, rnd=None):
    return loss_fn(w, batch, partial(encode_tokens, heads=cfg["num_attention_heads"]), rnd)
