"""Xing4.0 (``model_type`` ``xing4_0``; Xing4.0-29B-A4B): the port's
``models/xing4.py SentenceXing4``, one expert-parallel rank's share,
handed over as a checkpoint ``.npz`` in the published parameter names with
its ``config.json`` beside it, for ``--init-from ... --params-only``.

The DeepSeek-V3 block with q-LoRA and YaRN, and each sublayer's
hyper-connection: phi (``hc_attn.fn``, ``hc_mlp.fn``; (n^2 + 2n, n x
hidden)), b (``.base``) and alpha (``.scale``). As in
``families/deepseek_v3.py``: the configuration's ``n_routed_experts``
counts the experts held here, the router is ``n_routed_experts x
ep_chips`` wide and this chip, rank ``ep_rank``, holds experts ``ep_rank x
n_routed_experts`` onwards; the routers' correction biases are drawn from
that module's fixed seed, handed over in the checkpoint and given to the
reference apart.
"""

from __future__ import annotations

import json
import math
from functools import partial
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..gen import WEIGHTS, torch_seed
from ..reference.train import loss_fn
from ..reference.xing4 import encode_tokens
from .deepseek_v3 import ARCH_KEYS as DEEPSEEK_KEYS
from .deepseek_v3 import correction_biases, held, moe_layers, port_name, program_config
from .deepseek_v3 import router_width

__all__ = ["start_leaves", "hand_over", "program_config", "port_name", "loss", "step_flops"]

XING_KEYS = ("hc_mult", "hc_sinkhorn_iters", "hc_eps", "mhc_h_res_clamp_min",
             "mhc_h_res_clamp_max", "rope_scaling")


def mixes(cfg: Dict) -> int:
    return cfg["hc_mult"] * (cfg["hc_mult"] + 2)


def leaf_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every leaf, in the program's parameter order."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, rank, q_rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                                    cfg["v_head_dim"], cfg["kv_lora_rank"], cfg["q_lora_rank"])

    def swiglu(p, width):
        return [(p + "gate_proj.weight", (width, h)), (p + "up_proj.weight", (width, h)),
                (p + "down_proj.weight", (h, width))]

    def hc(p):
        return [(p + "fn", (mixes(cfg), cfg["hc_mult"] * h)), (p + "base", (mixes(cfg),)),
                (p + "scale", (3,))]

    out = [("model.embed_tokens.weight", (cfg["vocab_size"], h))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        out += hc(p + "hc_attn.")
        out += [(a + "q_a_proj.weight", (q_rank, h)), (a + "q_a_layernorm.weight", (q_rank,)),
                (a + "q_b_proj.weight", (nh * (nope + rope), q_rank)),
                (a + "kv_a_proj_with_mqa.weight", (rank + rope, h)),
                (a + "kv_a_layernorm.weight", (rank,)),
                (a + "kv_b_proj.weight", (nh * (nope + vd), rank)),
                (a + "o_proj.weight", (h, nh * vd))]
        out += hc(p + "hc_mlp.")
        if i in moe_layers(cfg):
            out.append((p + "mlp.gate.weight", (router_width(cfg), h)))
            for e in held(cfg):
                out += swiglu(f"{p}mlp.experts.{e}.", cfg["moe_intermediate_size"])
            out += swiglu(p + "mlp.shared_experts.",
                          cfg["moe_intermediate_size"] * cfg["n_shared_experts"])
        else:
            out += swiglu(p + "mlp.", cfg["intermediate_size"])
        out += [(p + "input_layernorm.weight", (h,)), (p + "post_attention_layernorm.weight", (h,))]
    out.append(("model.norm.weight", (h,)))
    return out


def start_leaves(cfg: Dict, seed: int, device) -> Dict[str, np.ndarray]:
    """Seeded on the device in one flat normal buffer: every projection,
    phi and the router std 1/sqrt(fan_in), the embedding std
    1/sqrt(hidden), every RMSNorm 1, each b the normal itself (std 1) and
    each alpha 1 + 0.2 x the normal. Returned as views of one host copy."""
    leaves = leaf_shapes(cfg)
    sizes = [int(np.prod(s)) for _, s in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, WEIGHTS))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    at = 0
    for (name, shape), n in zip(leaves, sizes):
        x = flat[at:at + n]
        if name.endswith(".scale"):
            x.mul_(0.2).add_(1.0)
        elif name.endswith(".base"):
            pass
        elif len(shape) == 1:
            x.fill_(1.0)
        else:
            x.mul_(1.0 / math.sqrt(shape[1]))
        at += n
    host, out, at = flat.cpu().numpy(), {}, 0
    del flat
    for (name, shape), n in zip(leaves, sizes):
        out[name] = host[at:at + n].reshape(shape)
        at += n
    return out


def program_config_json(cfg: Dict) -> Dict:
    """The checkpoint's ``config.json``: the architecture's keys as run,
    with the router's full width and the experts held here."""
    out = {k: cfg[k] for k in DEEPSEEK_KEYS + XING_KEYS if k in cfg}
    out.update(n_routed_experts=router_width(cfg), experts_held=held(cfg))
    return out


def hand_over(cfg: Dict, w0: Dict[str, np.ndarray], init: Path) -> List[str]:
    np.savez(init / "params.npz", **w0, **correction_biases(cfg))
    (init / "config.json").write_text(json.dumps(program_config_json(cfg), indent=1))
    return ["--init-from", str(init / "params.npz"), "--params-only"]


def loss(cfg: Dict, w, batch, rnd=None):
    device = next(iter(w.values())).device
    bias = {k: torch.from_numpy(v).to(device) for k, v in correction_biases(cfg).items()}
    ref_cfg = dict(cfg, n_routed_experts=router_width(cfg), experts_held=held(cfg))
    return loss_fn(w, batch, partial(encode_tokens, cfg=ref_cfg, bias=bias), rnd)


def mhc_flops(cfg: Dict) -> float:
    """One sublayer's mixing a token: phi's product (n x hidden by n^2 +
    2n), H_pre X (n x hidden), H_res X (n^2 x hidden) and H_post y (n x
    hidden), a multiply and an add each."""
    n, h = cfg["hc_mult"], cfg["hidden_size"]
    return 2.0 * n * h * (mixes(cfg) + 1 + n + 1)


def text_flops(n: int, cfg: Dict) -> float:
    """Forward FLOPs of one text of ``n`` non-padding tokens at the
    published widths: per token and layer the MLA projections (q_a, q_b,
    kv_a, kv_b, o), the dense SwiGLU or, in an expert layer, the router,
    the shared expert and the held experts at their expected share of the
    slots (top-k x held / router width), and the two sublayers' mixing; per
    causal (query, key) pair the score (q_nope + q_rope wide) and value
    products, every head."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, rank, q_rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                                    cfg["v_head_dim"], cfg["kv_lora_rank"], cfg["q_lora_rank"])
    mla = 2 * (h * q_rank + q_rank * nh * (nope + rope) + h * (rank + rope)
               + rank * nh * (nope + vd) + nh * vd * h)
    pairs = n * (n + 1) // 2
    attn = 2 * nh * (nope + rope + vd) * pairs
    dense = 3 * 2 * h * cfg["intermediate_size"]
    expert = 3 * 2 * h * cfg["moe_intermediate_size"]
    slots = cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / router_width(cfg)
    moe = 2 * h * router_width(cfg) + cfg["n_shared_experts"] * expert + slots * expert
    n_moe = len(moe_layers(cfg))
    n_dense = cfg["num_hidden_layers"] - n_moe
    layers = cfg["num_hidden_layers"]
    return float(layers * (n * (mla + 2 * mhc_flops(cfg)) + attn)
                 + n * (n_dense * dense + n_moe * moe))


def step_flops(a_tokens: Sequence[int], b_tokens: Sequence[int], h_tokens: Sequence[int],
               cfg: Dict) -> float:
    """One triplet step: three times the forward of anchors, positives and
    hard negatives, and the loss's two (B, B) products, as
    ``roofline.train_step_flops`` counts them; no recomputation."""
    fwd = sum(text_flops(n, cfg) for t in (a_tokens, b_tokens, h_tokens) for n in t)
    rows = len(a_tokens)
    return 3.0 * (fwd + 2 * 2.0 * rows * rows * cfg["hidden_size"])
