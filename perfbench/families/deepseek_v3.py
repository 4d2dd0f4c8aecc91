"""DeepSeek-V3 family (``model_type`` ``deepseek_v3``; Moonlight-16B-A3B):
the port's ``models/deepseek_v3.py SentenceDeepseekV3``, one
expert-parallel rank's share, handed over as a checkpoint ``.npz`` in the
published parameter names with its ``config.json`` beside it, for
``--init-from ... --params-only``.

The configuration's ``n_routed_experts`` counts the experts held here; the
router is ``n_routed_experts x ep_chips`` wide, and this chip, rank
``ep_rank``, holds experts ``ep_rank x n_routed_experts`` onwards.
Reference leaves are named and laid out as the program's parameters
(linear weights (out, in)). The routers' correction biases are buffers of
the program, not leaves: they are drawn from a fixed seed
(``CORRECTION_SEED``), handed over in the checkpoint, and given to the
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
from ..reference.deepseek_v3 import encode_tokens
from ..reference.train import loss_fn

__all__ = ["start_leaves", "hand_over", "program_config", "port_name", "loss", "step_flops"]

CORRECTION_SEED = 20250222
CORRECTION_STD = 0.1


def router_width(cfg: Dict) -> int:
    return cfg["n_routed_experts"] * cfg["ep_chips"]


def held(cfg: Dict) -> List[int]:
    n = cfg["n_routed_experts"]
    return list(range(cfg["ep_rank"] * n, (cfg["ep_rank"] + 1) * n))


def moe_layers(cfg: Dict) -> List[int]:
    return [i for i in range(cfg["num_hidden_layers"])
            if i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0]


def leaf_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every leaf, in the program's parameter order."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                            cfg["kv_lora_rank"])

    def swiglu(p, width):
        return [(p + "gate_proj.weight", (width, h)), (p + "up_proj.weight", (width, h)),
                (p + "down_proj.weight", (h, width))]

    out = [("model.embed_tokens.weight", (cfg["vocab_size"], h))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        out += [(a + "q_proj.weight", (nh * (nope + rope), h)),
                (a + "kv_a_proj_with_mqa.weight", (rank + rope, h)),
                (a + "kv_a_layernorm.weight", (rank,)),
                (a + "kv_b_proj.weight", (nh * (nope + vd), rank)),
                (a + "o_proj.weight", (h, nh * vd))]
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
    """Seeded on the device in one flat buffer: every projection and the
    router std 1/sqrt(fan_in), the embedding std 1/sqrt(hidden), every
    RMSNorm 1. Returned as views of one host copy."""
    leaves = leaf_shapes(cfg)
    total = sum(int(np.prod(s)) for _, s in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, WEIGHTS))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    at = 0
    for name, shape in leaves:
        n = int(np.prod(shape))
        x = flat[at:at + n]
        if len(shape) == 1:
            x.fill_(1.0)
        else:
            x.mul_(1.0 / math.sqrt(shape[1]))
        at += n
    host, out, at = flat.cpu().numpy(), {}, 0
    del flat
    for name, shape in leaves:
        n = int(np.prod(shape))
        out[name] = host[at:at + n].reshape(shape)
        at += n
    return out


def correction_biases(cfg: Dict) -> Dict[str, np.ndarray]:
    """Each expert layer's ``e_score_correction_bias`` over the router's
    width: normal, std ``CORRECTION_STD``, from a fixed seed."""
    return {f"model.layers.{i}.mlp.gate.e_score_correction_bias":
            np.random.default_rng([CORRECTION_SEED, i]).normal(
                0.0, CORRECTION_STD, router_width(cfg)).astype(np.float32)
            for i in moe_layers(cfg)}


ARCH_KEYS = ("model_type", "vocab_size", "hidden_size", "intermediate_size",
             "moe_intermediate_size", "num_hidden_layers", "num_attention_heads",
             "num_key_value_heads", "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
             "qk_rope_head_dim", "v_head_dim", "n_routed_experts", "num_experts_per_tok",
             "n_shared_experts", "routed_scaling_factor", "norm_topk_prob", "scoring_func",
             "topk_method", "n_group", "topk_group", "first_k_dense_replace", "moe_layer_freq",
             "hidden_act", "attention_bias", "rms_norm_eps", "rope_theta",
             "max_position_embeddings")


def program_config_json(cfg: Dict) -> Dict:
    """The checkpoint's ``config.json``: the architecture's keys as run,
    with the router's full width and the experts held here."""
    out = {k: cfg[k] for k in ARCH_KEYS if k in cfg}
    out.update(n_routed_experts=router_width(cfg), experts_held=held(cfg))
    return out


def hand_over(cfg: Dict, w0: Dict[str, np.ndarray], init: Path) -> List[str]:
    np.savez(init / "params.npz", **w0, **correction_biases(cfg))
    (init / "config.json").write_text(json.dumps(program_config_json(cfg), indent=1))
    return ["--init-from", str(init / "params.npz"), "--params-only"]


def program_config(cfg: Dict, pc):
    return pc


def port_name(name: str) -> Tuple[str, bool]:
    return name, False


def loss(cfg: Dict, w, batch, rnd=None):
    device = next(iter(w.values())).device
    bias = {k: torch.from_numpy(v).to(device) for k, v in correction_biases(cfg).items()}
    ref_cfg = dict(cfg, n_routed_experts=router_width(cfg), experts_held=held(cfg))
    return loss_fn(w, batch, partial(encode_tokens, cfg=ref_cfg, bias=bias), rnd)


def text_flops(n: int, cfg: Dict) -> float:
    """Forward FLOPs of one text of ``n`` non-padding tokens, at the
    published widths: per token and layer the MLA projections (q, kv_a,
    kv_b, o), the dense SwiGLU or, in an expert layer, the router, the
    shared experts and the held experts at their expected share of the
    slots (top-k x held / router width); per causal (query, key) pair the
    score (q_nope + q_rope wide) and value products, every head."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                            cfg["kv_lora_rank"])
    mla = 2 * (h * nh * (nope + rope) + h * (rank + rope) + rank * nh * (nope + vd) + nh * vd * h)
    pairs = n * (n + 1) // 2
    attn = 2 * nh * (nope + rope + vd) * pairs
    dense = 3 * 2 * h * cfg["intermediate_size"]
    expert = 3 * 2 * h * cfg["moe_intermediate_size"]
    slots = cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / router_width(cfg)
    moe = 2 * h * router_width(cfg) + cfg["n_shared_experts"] * expert + slots * expert
    n_moe = len(moe_layers(cfg))
    n_dense = cfg["num_hidden_layers"] - n_moe
    return float(cfg["num_hidden_layers"] * (n * mla + attn) + n * (n_dense * dense + n_moe * moe))


def step_flops(a_tokens: Sequence[int], b_tokens: Sequence[int], h_tokens: Sequence[int],
               cfg: Dict) -> float:
    """One triplet step: three times the forward of anchors, positives and
    hard negatives, and the loss's two (B, B) products, as
    ``roofline.train_step_flops`` counts them."""
    fwd = sum(text_flops(n, cfg) for t in (a_tokens, b_tokens, h_tokens) for n in t)
    rows = len(a_tokens)
    return 3.0 * (fwd + 2 * 2.0 * rows * rows * cfg["hidden_size"])
