"""PyTorch port vs JAX reference: every combination of the block's
variants, on the CPU in float32.

Position (alibi, rope, learned) x norm (layernorm, rmsnorm) x activation
(gelu, swiglu) x GQA (4 heads on 4 or on 2 kv heads) x tied/untied head,
on the ``test`` geometry at one layer: logits, loss and every grad of the
port against JAX ``value_and_grad`` on the same converted weights and
tokens, atol 1e-4 (``test_torch_llama._check_against_jax``).
"""
import itertools

import pytest
import torch

from test_torch_llama import _check_against_jax, _configs


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


VARIANTS = list(itertools.product(("alibi", "rope", "learned"), ("layernorm", "rmsnorm"), ("gelu", "swiglu"),
                                  (4, 2), (True, False)))


@pytest.mark.parametrize("position,norm,activation,kv_heads,tied", VARIANTS,
                         ids=["-".join(map(str, v)) for v in VARIANTS])
def test_variant_matches_jax(position, norm, activation, kv_heads, tied):
    over = dict(position=position, norm=norm, activation=activation, n_kv_heads=kv_heads, tie_embeddings=tied,
                n_layers=1)
    jcfg, tcfg = _configs("test", **over)
    model, _ = _check_against_jax(jcfg, tcfg, seed=3)
    assert (model.wpe is not None) == (position == "learned")
    assert (model.lm_head is None) == tied
    assert (model.blocks[0].mlp.gate is not None) == (activation == "swiglu")
