"""PyTorch port vs JAX reference: the differentiable flash attention.

The same seeded numpy inputs go through JAX ``ops/pallas/flash.py::
flash_attention`` in Pallas interpret mode under ``jax.vjp`` and through the
port's ``ops.flash.flash_attention`` (a ``torch.autograd.Function``; on CPU
tensors its forward is ``flash_reference`` and its backward
``flash_bwd_reference``, the plain versions of K1 and of K2/K3). Out, dq, dk
and dv agree within atol 1e-5 in float32, over MHA and GQA (8 query heads
on 2 kv heads), ALiBi on and off, causal on and off, T = S in {64, 128},
D = 64; at D = 128 (the head width of the wgmma kernels on the card) over
MHA and GQA, causal with ALiBi, and GQA non-causal. With packed-document
ids (``doc_ids``, exclusive-cumsum ids from rows with separators at 0, at
T-1, back to back, on a 64-key tile edge, and a row with none), the same
holds, and ``flash_reference`` alone against the JAX forward, over MHA and
GQA at D = 64 and GQA at D = 128.

Then ``flash_bwd_reference`` against autograd through the port's own
``xla_attention``, and the dispatch gate: a training-shape call that needs
grads goes to the Function, with or without ``doc_ids``; a serving shape
that needs grads, and ``doc_ids`` on a serving shape, still decline, and so
raise off the CPU.
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


def _port(q, k, v, do, causal, alibi, docs=None):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ids = None if docs is None else torch.from_numpy(docs)
    out = tflash.flash_attention(tq, tk, tv, causal=causal, alibi=alibi, doc_ids=ids)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


# (heads, alibi, causal, T, D): every combination at D = 64, and at D = 128
# (580m's head width, the wgmma kernels' path on the card) MHA and GQA,
# causal with ALiBi, and one non-causal case
HEADS = {"mha": (4, 4), "gqa": (8, 2)}
PARITY_CASES = [
    pytest.param(HEADS[h], alibi, causal, T, 64,
                 id=f"{h}-{'alibi' if alibi else 'no_alibi'}-{'causal' if causal else 'full'}-{T}")
    for h in HEADS for alibi in (True, False) for causal in (True, False) for T in (64, 128)
] + [
    pytest.param(HEADS["mha"], True, True, 128, 128, id="mha-alibi-causal-128-d128"),
    pytest.param(HEADS["gqa"], True, True, 128, 128, id="gqa-alibi-causal-128-d128"),
    pytest.param(HEADS["gqa"], True, False, 64, 128, id="gqa-alibi-full-64-d128"),
]


@pytest.mark.parametrize("heads,alibi,causal,T,D", PARITY_CASES)
def test_flash_attention_and_grads_match_jax_interpret(heads, alibi, causal, T, D):
    H, KVH = heads
    q, k, v, do = _inputs(T + H + 2 * alibi + causal + D - 64, 2, T, H, KVH, D)

    def fwd(q, k, v):
        return jflash.flash_attention(q, k, v, causal=causal, alibi=alibi, block=64, interpret=True)

    out, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [out, *vjp(jnp.asarray(do))]
    got = _port(q, k, v, do, causal, alibi)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0, err_msg=name)


def _doc_ids(T):
    """[4, T] exclusive-cumsum ids (the model's rule): separators at 0 and
    T-1, three back to back, on the 64-key tile edge (63, 64, 65), none."""
    sep = np.zeros((4, T), bool)
    sep[0, [0, T // 3, T - 1]] = True
    sep[1, [5, 6, 7, T // 2]] = True
    sep[2, [63, 64, 65]] = True
    ids = np.cumsum(sep, axis=1) - sep
    return ids.astype(np.int32)


@pytest.mark.parametrize("heads,D", [((4, 4), 64), ((8, 2), 64), ((8, 2), 128)], ids=["mha", "gqa", "gqa_d128"])
def test_flash_attention_with_doc_ids_matches_jax_interpret(heads, D):
    H, KVH = heads
    T = 128
    q, k, v, do = _inputs(H + 7 + (D > 64), 4, T, H, KVH, D)
    docs = _doc_ids(T)

    def fwd(q, k, v):
        return jflash.flash_attention(q, k, v, causal=True, alibi=True, doc_ids=jnp.asarray(docs),
                                      block=64, interpret=True)

    out, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [out, *vjp(jnp.asarray(do))]
    got = _port(q, k, v, do, True, True, docs)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0, err_msg=name)
    # the plain version of K1 alone, lse included, against the JAX forward
    ref, lse = tflash.flash_reference(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                                      alibi=True, doc_ids=torch.from_numpy(docs))
    j_out, j_lse = jflash._fwd(*(jnp.asarray(x) for x in (q, k, v)), True, True, D**-0.5, 64, 64, True,
                               q_ids=jnp.asarray(docs), k_ids=jnp.asarray(docs))
    np.testing.assert_allclose(ref.numpy(), np.asarray(j_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], atol=ATOL, rtol=0)
    # the mask does something: without it the output moves
    free = _port(q, k, v, do, True, True)
    assert np.abs(free[0] - got[0]).max() > 1e-2


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
    # the packed-document mask rides the training shape, grads or not: the
    # gate declines the meta tensor for its device only, and on the CPU the
    # wrapper takes the Function
    docs = torch.zeros(1, 16, dtype=torch.int32)
    reason = tfa.decline_reason(qm, km, km, causal=True, alibi=True, doc_ids=docs)
    assert "CUDA" in reason and "packed-document" not in reason
    with pytest.raises(NotImplementedError, match="CUDA"):
        tattn.dot_product_attention(qm.detach(), km.detach(), km.detach(), causal=True, alibi=True,
                                    doc_ids=docs, impl="auto")
    out = tfa.flash_attention(q, k, v, causal=True, alibi=True, doc_ids=docs)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    # on a serving shape, or with ids of the wrong shape, it declines
    with pytest.raises(NotImplementedError, match="packed-document mask .* serving shape"):
        tattn.dot_product_attention(qm.detach(), km.detach(), km.detach(), causal=True, alibi=True,
                                    q_offset=offs, doc_ids=docs, impl="auto")
    assert "packed-document" in tfa.decline_reason(qm, km[:, :8], km[:, :8], causal=True, alibi=True,
                                                   doc_ids=docs)
    with pytest.raises(NotImplementedError, match="packed-document"):
        tfa.flash_attention(q, k, v, causal=True, alibi=True, q_offset=offs, doc_ids=docs)
