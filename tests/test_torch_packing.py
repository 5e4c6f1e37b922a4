"""PyTorch port vs JAX reference: packed-document models, on the CPU.

The same seeded numpy token rows through the JAX package and the port:

- ``doc_ids_from_tokens`` and ``mask_boundary_labels`` equal JAX's on rows
  with separators at 0, at T-1, back to back, and none;
- the ``test`` model with ``doc_sep_token=0`` in float32, the port's
  weights converted from the JAX init: logits within 1e-4 of JAX
  ``Transformer.apply``, the packed loss within rtol 1e-6 of JAX's and
  every grad within 1e-6 of ``jax.value_and_grad``, with the port's
  attention through ``xla_attention`` and, in a second pass, through the
  kernel wrapper's differentiable entry (on the CPU, the plain versions of
  K1-K3 behind the autograd Function);
- a document inside a packed row gets the logits it gets alone (JAX
  ``tests/test_packing.py:31``), and without packing it does not;
- ``byte_25m`` and ``byte_2m`` build, and the separator is validated as JAX
  validates it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_transformer_tpu.config import model_config as jax_model_config
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.models.gpt import doc_ids_from_tokens as jax_doc_ids
from zero_transformer_tpu.models.gpt import mask_boundary_labels as jax_mask_labels
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.models import gpt as tgpt
from zero_transformer_tpu_torch.models import model_getter
from zero_transformer_tpu_torch.models.gpt import Transformer, doc_ids_from_tokens, mask_boundary_labels
from zero_transformer_tpu_torch.ops import flash_attention as tfa

SEP = 0
MODEL = dict(dropout=0.0, compute_dtype="float32", doc_sep_token=SEP)
T = 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rows(seed=0):
    """[4, T] token rows: separators at 0 and T-1, three back to back, none."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, 256, (4, T)).astype(np.int32)
    rows[0, [0, 9, T - 1]] = SEP
    rows[1, [4, 5, 6, 20]] = SEP
    rows[2, [15]] = SEP
    return rows


def test_doc_ids_and_boundary_labels_match_jax():
    rows = _rows()
    want_ids = np.asarray(jax_doc_ids(jnp.asarray(rows), SEP))
    got_ids = doc_ids_from_tokens(torch.from_numpy(rows), SEP)
    assert got_ids.dtype == torch.int32
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    assert (got_ids[3] == 0).all() and got_ids[0, 0] == 0 and got_ids[0, 1] == 1
    want = np.asarray(jax_mask_labels(jnp.asarray(rows), jnp.asarray(want_ids)))
    got = mask_boundary_labels(torch.from_numpy(rows), got_ids)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == -1).sum() == (want == -1).sum() > 0


def _models(seed=0):
    jcfg = jax_model_config("test", **MODEL)
    jmodel = JaxTransformer(jcfg)
    params = unbox(jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])
    port = Transformer(tconfig.model_config("test", **MODEL), device="cpu")
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, port.requires_grad_(True)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_packed_logits_loss_and_grads_match_jax(impl, monkeypatch):
    jmodel, params, port = _models()
    if impl == "flash":
        # what the dispatcher calls on the card once the gate accepts; on the
        # CPU the wrapper's Function runs the kernels' plain versions
        def through_wrapper(q, k, v, *, causal, alibi, doc_ids, impl):
            return tfa.flash_attention(q, k, v, causal=causal, alibi=alibi, doc_ids=doc_ids)

        monkeypatch.setattr(tgpt, "dot_product_attention", through_wrapper)
    rows = _rows(1)
    tokens = jnp.asarray(rows)

    def loss_fn(p):
        return jmodel.apply({"params": p}, tokens, labels=tokens, train=True)[1]

    want_logits = np.asarray(jmodel.apply({"params": params}, tokens))
    loss, grads = jax.value_and_grad(loss_fn)(params)
    t = torch.from_numpy(rows)
    logits = port(t)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=1e-4, rtol=0)
    _, t_loss = port(t, labels=t, train=True)
    np.testing.assert_allclose(float(t_loss.detach()), float(loss), rtol=1e-6)
    names = [n for n, _ in port.named_parameters()]
    t_grads = torch.autograd.grad(t_loss, [p for _, p in port.named_parameters()])
    want = params_from_jax(jax.tree.map(np.asarray, grads))
    for n, g in zip(names, t_grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-6, rtol=0, err_msg=n)


def test_packed_document_matches_standalone():
    _, _, port = _models(2)
    rng = np.random.default_rng(3)
    doc1 = list(rng.integers(1, 256, 9)) + [SEP]
    doc2 = list(rng.integers(1, 256, 12))
    with torch.no_grad():
        packed = port(torch.tensor([doc1 + doc2]))
        solo1 = port(torch.tensor([doc1]))
        solo2 = port(torch.tensor([doc2]))
    np.testing.assert_allclose(packed[0, len(doc1):].numpy(), solo2[0].numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(packed[0, :len(doc1)].numpy(), solo1[0].numpy(), atol=2e-5, rtol=2e-5)
    # without packing, doc2's logits depend on doc1
    unpacked = Transformer(tconfig.model_config("test", dropout=0.0, compute_dtype="float32"), device="cpu")
    unpacked.load_state_dict(port.state_dict())
    with torch.no_grad():
        bleed = unpacked(torch.tensor([doc1 + doc2]))[0, len(doc1):]
    assert not np.allclose(bleed.numpy(), solo2[0].numpy(), atol=1e-4)


@pytest.mark.parametrize("name", ["byte_25m", "byte_2m"])
def test_byte_models_build(name):
    model, cfg = model_getter(name, device="cpu", return_cfg=True)
    assert cfg.doc_sep_token == 0 and cfg.vocab_size == 256 and cfg.max_seq_len == 512
    assert cfg.num_params == jax_model_config(name).num_params
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params


def test_separator_is_validated_as_in_jax():
    with pytest.raises(ValueError, match="outside vocab"):
        tconfig.model_config("test", doc_sep_token=256)
    with pytest.raises(ValueError, match="relative position"):
        tconfig.ModelConfig(position="learned", doc_sep_token=0)
    # the MoE and Llama byte variants stay unported
    for name in ("byte_2m_moe", "byte_2m_llama"):
        with pytest.raises(ValueError, match="model name"):
            tconfig.model_config(name)
