"""Encoder parity: the PyTorch SentenceBert against the flax SentenceBert.

The same seeded parameter tree (made by the JAX package's ``init_params``)
goes through ``params_from_jax`` into the port, and the same token ids go
through both models on the CPU.

Tolerances: at compute dtype float32 both forwards are IEEE fp32 with the
same operation order up to the summation order inside matmuls and the
LayerNorm variance formula (flax E[x²]-E[x]², torch two-pass), so the
L2-normalized embeddings agree to atol 2e-5. At bfloat16 the frameworks
round at different places (bias add, GELU), so the check is atol 2e-2
plus cosine >= 0.999 per row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_icd10_tpu.models import bert as jbert
from rag_icd10_tpu.models import convert_hf as jconvert
from rag_icd10_tpu_torch.models import bert as tbert
from rag_icd10_tpu_torch.models.convert_hf import load_params, params_from_jax

torch.set_num_threads(2)  # the suite runs several test processes at once

SMALL = dict(
    vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
    intermediate_size=128, max_position_embeddings=64,
)


def _tokens(seed=0, b=4, s=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, SMALL["vocab_size"], size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 9:] = 0  # ragged rows: padding must not contribute
    mask[3, 4:] = 0
    ids[mask == 0] = 0
    types = np.zeros_like(ids)
    return ids, mask, types


def _jax_tree(params):
    return {"bert": {k: v for k, v in params["bert"].items()}}


def _run_both(dtype_j, dtype_t, seed=0):
    arch_j = jbert.BertArch(**SMALL, compute_dtype=dtype_j)
    params = jbert.init_params(arch_j, seed=seed)
    ids, mask, types = _tokens(seed)
    want = np.asarray(
        jbert.SentenceBert(arch_j).apply(
            {"params": params}, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types)
        ),
        dtype=np.float32,
    )
    model = tbert.SentenceBert(tbert.BertArch(**SMALL, compute_dtype=dtype_t))
    model.load_state_dict(params_from_jax(_jax_tree(params)))
    model.eval()
    with torch.inference_mode():
        got = model(
            torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
            torch.from_numpy(types).long(),
        ).numpy()
    return got, want, params


def test_fp32_parity():
    got, want, _ = _run_both(jnp.float32, torch.float32)
    assert got.shape == want.shape == (4, SMALL["hidden_size"])
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_bf16_parity():
    got, want, _ = _run_both(jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(got, want, atol=2e-2)
    cos = np.sum(got * want, axis=1) / (
        np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1)
    )
    assert cos.min() >= 0.999, cos


def test_embeddings_unit_norm_and_finite():
    got, _, _ = _run_both(jnp.float32, torch.float32, seed=3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_npz_round_trip(tmp_path):
    """A weights file written by the JAX package loads through the port's
    ``load_params`` into identical tensors."""
    arch = jbert.BertArch(**SMALL, compute_dtype=jnp.float32)
    params = jbert.init_params(arch, seed=1)
    path = str(tmp_path / "w.npz")
    jconvert.save_params(params, path)
    direct = params_from_jax(_jax_tree(params))
    loaded = params_from_jax(load_params(path))
    assert direct.keys() == loaded.keys()
    for key in direct:
        assert torch.equal(direct[key], loaded[key]), key
    # and the tree loads strictly into the module (every key, every shape)
    model = tbert.SentenceBert(tbert.BertArch(**SMALL, compute_dtype=torch.float32))
    model.load_state_dict(loaded)


def test_dense_kernels_are_transposed():
    arch = jbert.BertArch(**SMALL, compute_dtype=jnp.float32)
    params = jbert.init_params(arch, seed=2)
    sd = params_from_jax(_jax_tree(params))
    kernel = np.asarray(params["bert"]["layer_0"]["intermediate"]["kernel"])
    assert kernel.shape == (SMALL["hidden_size"], SMALL["intermediate_size"])
    np.testing.assert_array_equal(
        sd["bert.layers.0.intermediate.weight"].numpy(), kernel.T
    )


@pytest.mark.parametrize("seed", [0, 5])
def test_port_init_params_loads(seed):
    """The port's own numpy init has the JAX layout and loads strictly."""
    arch = tbert.BertArch(**SMALL, compute_dtype=torch.float32)
    tree = tbert.init_params(arch, seed=seed)
    model = tbert.SentenceBert(arch)
    model.load_state_dict(params_from_jax(tree))
    again = params_from_jax(tbert.init_params(arch, seed=seed))
    for key, value in model.state_dict().items():
        assert torch.equal(value, again[key]), key
