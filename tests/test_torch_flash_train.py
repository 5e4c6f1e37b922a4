"""PyTorch port vs JAX reference: the differentiable flash attention.

The same seeded numpy inputs go through JAX ``ops/pallas/flash.py::
flash_attention`` in Pallas interpret mode under ``jax.vjp`` and through the
port's ``ops.flash.flash_attention`` (a ``torch.autograd.Function``; on CPU
tensors its forward is ``flash_reference`` and its backward
``flash_bwd_reference``, the plain versions of K1 and of K2/K3). Out, dq, dk
and dv agree within atol 1e-5 in float32, over MHA and GQA (8 query heads
on 2 kv heads), ALiBi on and off, causal on and off, T = S in {64, 128},
D = 64.

Then ``flash_bwd_reference`` against autograd through the port's own
``xla_attention``, and the dispatch gate: a training-shape call that needs
grads goes to the Function; a serving shape that needs grads and a
``doc_ids`` call still decline, and so raise off the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_transformer_tpu.ops.pallas import flash as jflash
from zero_transformer_tpu_torch.ops import attention as tattn
from zero_transformer_tpu_torch.ops import flash as tflash
from zero_transformer_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, B, T, H, KVH, D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, h, D)).astype(np.float32) for h in (H, KVH, KVH))
    do = rng.standard_normal((B, T, H, D)).astype(np.float32)
    return q, k, v, do


def _port(q, k, v, do, causal, alibi):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal=causal, alibi=alibi)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("T", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("alibi", [True, False], ids=["alibi", "no_alibi"])
@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_flash_attention_and_grads_match_jax_interpret(heads, alibi, causal, T):
    H, KVH = heads
    q, k, v, do = _inputs(T + H + 2 * alibi + causal, 2, T, H, KVH, 64)

    def fwd(q, k, v):
        return jflash.flash_attention(q, k, v, causal=causal, alibi=alibi, block=64, interpret=True)

    out, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [out, *vjp(jnp.asarray(do))]
    got = _port(q, k, v, do, causal, alibi)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", [(2, 48, 4, 4, True, True), (1, 40, 8, 2, True, False),
                                  (2, 24, 6, 3, False, True)],
                         ids=["mha_alibi", "gqa_causal", "gqa_full"])
def test_flash_bwd_reference_matches_autograd_through_xla_attention(case):
    B, T, H, KVH, causal, alibi = case
    q, k, v, do = _inputs(T, B, T, H, KVH, 64)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ref = tattn.xla_attention(tq, tk, tv, causal=causal, alibi=alibi)
    want = torch.autograd.grad(ref, (tq, tk, tv), torch.from_numpy(do))
    o, lse = tflash.flash_reference(tq.detach(), tk.detach(), tv.detach(), causal=causal, alibi=alibi)
    got = tflash.flash_bwd_reference(tq.detach(), tk.detach(), tv.detach(), o, lse, torch.from_numpy(do),
                                     causal=causal, alibi=alibi)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=0, err_msg=name)
    # flash_bwd on CPU tensors is the plain version
    again = tflash.flash_bwd(tq.detach(), tk.detach(), tv.detach(), o, lse, torch.from_numpy(do),
                             causal=causal, alibi=alibi)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_gate_routes_training_shape_with_grad_to_the_function():
    q = torch.zeros(1, 16, 4, 64, requires_grad=True)
    k = v = torch.zeros(1, 16, 4, 64, requires_grad=True)
    # the wrapper sends the training shape to the differentiable entry
    out = tfa.flash_attention(q, k, v, causal=True, alibi=True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    qm, km = (x.detach().to("meta").requires_grad_() for x in (q, k))
    # off the CPU a training-shape call that needs grads is not declined for
    # the grad (a meta tensor is declined for its device, a CUDA one launches)
    reason = tfa.decline_reason(qm, km, km, causal=True, alibi=True)
    assert "CUDA" in reason and "grad" not in reason
    with pytest.raises(NotImplementedError, match="CUDA"):
        tattn.dot_product_attention(qm, km, km, causal=True, alibi=True, impl="auto")
    # a serving shape (per-row offsets) that needs grads still declines
    offs = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="requires grad on a serving shape"):
        tattn.dot_product_attention(qm, km, km, causal=True, alibi=True, q_offset=offs, impl="auto")
    with pytest.raises(NotImplementedError, match="requires grad on a serving shape"):
        tattn.dot_product_attention(qm, km, km, causal=True, alibi=True,
                                    segment_ids=torch.ones(1, 16, dtype=torch.int32), impl="flash")
    # so does the packed-document mask, with or without grads
    docs = torch.zeros(1, 16, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="packed-document"):
        tattn.dot_product_attention(qm.detach(), km.detach(), km.detach(), causal=True, alibi=True,
                                    doc_ids=docs, impl="auto")
    with pytest.raises(NotImplementedError, match="packed-document"):
        tfa.flash_attention(q, k, v, causal=True, alibi=True, doc_ids=docs)
