"""Kimi-Linear (``model_type`` ``kimi_linear``; Kimi-Linear-48B-A3B): the
port's ``models/kimi_linear.py SentenceKimiLinear``, one expert-parallel
rank's share, handed over as a checkpoint ``.npz`` in the checkpoint's
parameter names with its ``config.json`` beside it, for ``--init-from ...
--params-only``.

The configuration's ``num_experts`` counts the experts held here; the
router is ``num_experts x ep_chips`` wide, and this chip, rank
``ep_rank``, holds experts ``ep_rank x num_experts`` onwards.
``linear_attn_config``'s 1-based lists say which layers are delta-rule
layers and which latent attention. Reference leaves are named and laid out
as the program's parameters. The routers' correction biases are buffers
of the program, not leaves: drawn from a fixed seed (``CORRECTION_SEED``),
handed over in the checkpoint, and given to the reference apart.
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
from ..reference.kimi_linear import encode_tokens
from ..reference.train import loss_fn

__all__ = ["start_leaves", "hand_over", "program_config", "port_name", "loss", "step_flops"]

CORRECTION_SEED = 20251030
CORRECTION_STD = 0.1


def router_width(cfg: Dict) -> int:
    return cfg["num_experts"] * cfg["ep_chips"]


def held(cfg: Dict) -> List[int]:
    n = cfg["num_experts"]
    return list(range(cfg["ep_rank"] * n, (cfg["ep_rank"] + 1) * n))


def moe_layers(cfg: Dict) -> List[int]:
    return [i for i in range(cfg["num_hidden_layers"])
            if i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0]


def kda_layers(cfg: Dict) -> List[int]:
    """The 0-based delta-rule layers (the published lists are 1-based)."""
    listed = cfg["linear_attn_config"]["kda_layers"]
    return [i for i in range(cfg["num_hidden_layers"]) if i + 1 in listed]


def leaf_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every leaf."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                            cfg["kv_lora_rank"])
    lin = cfg["linear_attn_config"]
    d, heads, conv = lin["head_dim"], lin["num_heads"], lin["short_conv_kernel_size"]
    width = d * heads

    def swiglu(p, inner):
        return [(p + "gate_proj.weight", (inner, h)), (p + "up_proj.weight", (inner, h)),
                (p + "down_proj.weight", (h, inner))]

    out = [("model.embed_tokens.weight", (cfg["vocab_size"], h))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        if i in kda_layers(cfg):
            out += [(a + f"{x}_proj.weight", (width, h)) for x in "qkv"]
            out += [(a + f"{x}_conv1d.weight", (width, 1, conv)) for x in "qkv"]
            out += [(a + "f_a_proj.weight", (d, h)), (a + "f_b_proj.weight", (width, d)),
                    (a + "dt_bias", (width,)), (a + "A_log", (heads,)),
                    (a + "b_proj.weight", (heads, h)), (a + "g_a_proj.weight", (d, h)),
                    (a + "g_b_proj.weight", (width, d)), (a + "g_b_proj.bias", (width,)),
                    (a + "o_norm.weight", (d,)), (a + "o_proj.weight", (h, width))]
        else:
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
                          cfg["moe_intermediate_size"] * cfg["num_shared_experts"])
        else:
            out += swiglu(p + "mlp.", cfg["intermediate_size"])
        out += [(p + "input_layernorm.weight", (h,)), (p + "post_attention_layernorm.weight", (h,))]
    out.append(("model.norm.weight", (h,)))
    return out


def _law(name: str) -> str:
    if name.endswith("norm.weight"):
        return "one"
    if name.endswith("g_b_proj.bias"):
        return "zero"
    if name.endswith("A_log") or name.endswith("dt_bias"):
        return name.rsplit(".", 1)[1]
    return "normal"


def start_leaves(cfg: Dict, seed: int, device) -> Dict[str, np.ndarray]:
    """Seeded on the device: one flat normal buffer, every projection, the
    router and the short convolutions std 1/sqrt(fan_in), the embedding std
    1/sqrt(hidden), every RMSNorm and o_norm 1, g_b_proj's bias 0; then
    uniforms for A_log = log U(1, 16) and dt_bias, the inverse softplus of
    exp U(log 1e-3, log 0.1). Returned as views of one host copy."""
    leaves = leaf_shapes(cfg)
    sizes = [int(np.prod(s)) for _, s in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, WEIGHTS))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    at = 0
    for (name, shape), n in zip(leaves, sizes):
        x, law = flat[at:at + n], _law(name)
        if law == "one":
            x.fill_(1.0)
        elif law == "zero":
            x.zero_()
        elif law == "normal":
            x.mul_(1.0 / math.sqrt(int(np.prod(shape[1:]))))
        else:
            u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
            if law == "A_log":
                x.copy_(torch.log(1.0 + 15.0 * u))
            else:
                dt = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
                x.copy_(dt + torch.log(-torch.expm1(-dt)))
        at += n
    host, out, at = flat.cpu().numpy(), {}, 0
    del flat
    for (name, shape), n in zip(leaves, sizes):
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


ARCH_KEYS = ("model_type", "vocab_size", "hidden_size", "head_dim", "intermediate_size",
             "moe_intermediate_size", "num_hidden_layers", "num_attention_heads",
             "num_key_value_heads", "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
             "qk_rope_head_dim", "v_head_dim", "mla_use_nope", "linear_attn_config",
             "num_experts", "num_experts_per_token", "num_shared_experts",
             "routed_scaling_factor", "moe_renormalize", "moe_router_activation_func",
             "num_expert_group", "topk_group", "use_grouped_topk", "first_k_dense_replace",
             "moe_layer_freq", "hidden_act", "rms_norm_eps", "rope_theta", "rope_scaling")


def program_config_json(cfg: Dict) -> Dict:
    """The checkpoint's ``config.json``: the architecture's keys as run,
    with the router's full width and the experts held here."""
    out = {k: cfg[k] for k in ARCH_KEYS if k in cfg}
    out.update(num_experts=router_width(cfg), experts_held=held(cfg))
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
    ref_cfg = dict(cfg, num_experts=router_width(cfg), experts_held=held(cfg))
    return loss_fn(w, batch, partial(encode_tokens, cfg=ref_cfg, bias=bias), rnd)


def text_flops(n: int, cfg: Dict) -> float:
    """Forward FLOPs of one text of ``n`` non-padding tokens at the
    published widths. Per token: in a delta-rule layer its projections (q,
    k, v, f_a, f_b, b, g_a, g_b, o), its convolutions and the recurrence,
    7 d_k d_v a head (decay, erase, write, read); in a latent-attention
    layer its projections, and per causal (query, key) pair the score and
    value products, every head; the dense SwiGLU or, in an expert layer,
    the router, the shared expert and the held experts at their expected
    share of the slots (top-k x held / router width)."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                            cfg["kv_lora_rank"])
    lin = cfg["linear_attn_config"]
    d, heads, conv = lin["head_dim"], lin["num_heads"], lin["short_conv_kernel_size"]
    width = d * heads
    kda = (2 * (h * (3 * width + 2 * d + heads) + 2 * d * width + width * h)
           + 2 * 3 * width * conv + 7 * d * d * heads)
    mla = 2 * (h * nh * (nope + rope) + h * (rank + rope) + rank * nh * (nope + vd) + nh * vd * h)
    pairs = n * (n + 1) // 2
    attn = 2 * nh * (nope + rope + vd) * pairs
    dense = 3 * 2 * h * cfg["intermediate_size"]
    expert = 3 * 2 * h * cfg["moe_intermediate_size"]
    slots = cfg["num_experts_per_token"] * cfg["num_experts"] / router_width(cfg)
    moe = 2 * h * router_width(cfg) + cfg["num_shared_experts"] * expert + slots * expert
    n_kda, n_moe = len(kda_layers(cfg)), len(moe_layers(cfg))
    n_mla = cfg["num_hidden_layers"] - n_kda
    n_dense = cfg["num_hidden_layers"] - n_moe
    return float(n * (n_kda * kda + n_mla * mla + n_dense * dense + n_moe * moe) + n_mla * attn)


def step_flops(a_tokens: Sequence[int], b_tokens: Sequence[int], h_tokens: Sequence[int],
               cfg: Dict) -> float:
    """One triplet step: three times the forward of anchors, positives and
    hard negatives, and the loss's two (B, B) products, as
    ``roofline.train_step_flops`` counts them."""
    fwd = sum(text_flops(n, cfg) for t in (a_tokens, b_tokens, h_tokens) for n in t)
    rows = len(a_tokens)
    return 3.0 * (fwd + 2 * 2.0 * rows * rows * cfg["hidden_size"])
