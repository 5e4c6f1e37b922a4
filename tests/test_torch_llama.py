"""PyTorch port vs JAX reference: the Llama block and the model variants,
on the CPU in float32.

- ``ModelConfig.num_params`` equals JAX's for every entry of
  ``configs/models.yaml`` (the MoE entries through the port's formula on
  their dense fields), and counts the port's params; ``llama3_8b`` has
  8,030,261,248;
- ``apply_rope`` against JAX at positions up to 8191 with theta 500000
  (atol 1e-5), its inverse frequencies bit-equal;
- logits, loss and every grad against JAX (atol 1e-4) for ``llama3_test``,
  ``byte_2m_llama`` on packed rows and ``llama3_8b`` narrowed to d 128 (8
  heads on 2 kv heads, theta 500000, 2 layers), scanned and unscanned JAX
  trees;
- learned positions refuse a row past their table, as JAX does (every
  combination of the variants is in ``test_torch_llama_variants.py``);
- ``remat_policy`` none, dots and qkv_mlp: loss and grads bit-equal to no
  remat, and the backward's matrix products show what each policy
  recomputes (per layer: none 6, qkv_mlp 1, dots 0);
- ``weight_decay_mask`` leaf for leaf against JAX's path rule (``wpe`` not
  decayed), ``tree_digests`` per JAX leaf, and the converter's round trips
  (float and int8, the untied head and the gate included).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch.utils._python_dispatch import TorchDispatchMode

from zero_transformer_tpu import checkpoint as jckpt
from zero_transformer_tpu.config import load_model_zoo
from zero_transformer_tpu.config import model_config as jax_model_config
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.models.quant import quantize_params as j_quantize_params
from zero_transformer_tpu.ops.positions import apply_rope as jax_apply_rope
from zero_transformer_tpu.ops.positions import rope_frequencies as jax_rope_frequencies
from zero_transformer_tpu.parallel.sharding import unbox
from zero_transformer_tpu.training.optimizer import weight_decay_mask as jax_weight_decay_mask
from zero_transformer_tpu_torch import checkpoint as ckpt
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.convert import params_from_jax, params_to_jax
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.models.quant import quantize_model, quantize_params
from zero_transformer_tpu_torch.ops.positions import apply_rope, rope_frequencies
from zero_transformer_tpu_torch.training.optimizer import weight_decay_mask

ATOL = 1e-4
F32 = dict(dropout=0.0, compute_dtype="float32")
# llama3_8b at d 128: its theta, its 4:1 GQA and its block, 2 layers
NARROW_8B = dict(d_model=128, n_heads=8, n_kv_heads=2, d_ff=448, vocab_size=512, n_layers=2)
MODELS = {"llama3_test": ("llama3_test", {}), "byte_2m_llama": ("byte_2m_llama", {}),
          "llama3_8b_narrow": ("llama3_8b", NARROW_8B)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _configs(zoo, **over):
    jcfg = jax_model_config(zoo, **F32, **over)
    return jcfg, tconfig.model_config(zoo, **F32, **over)


def _jax_params(jcfg, seed=0):
    params = JaxTransformer(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, unbox(params))


def _port_model(tcfg, tree):
    model = Transformer(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model.requires_grad_(True)


def _tokens(jcfg, seed=1, B=2, T=24):
    tokens = np.random.default_rng(seed).integers(1, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    if jcfg.doc_sep_token is not None:  # packed rows: separators inside and at an edge
        tokens[0, [5, 6, 17]] = jcfg.doc_sep_token
        tokens[1, [0, 11]] = jcfg.doc_sep_token
    return tokens


def _check_against_jax(jcfg, tcfg, seed=0):
    """Logits, loss and every grad of the port against JAX on one batch."""
    tree = _jax_params(jcfg, seed)
    tokens = _tokens(jcfg, seed + 1)
    jmodel = JaxTransformer(jcfg)

    def loss_fn(p):
        return jmodel.apply({"params": p}, jnp.asarray(tokens), labels=jnp.asarray(tokens), train=True)

    (loss, logits), grads = jax.value_and_grad(lambda p: loss_fn(p)[::-1], has_aux=True)(tree)
    model = _port_model(tcfg, tree)
    t = torch.from_numpy(tokens).long()
    t_logits, t_loss = model(t, labels=t, train=True)
    names = [n for n, _ in model.named_parameters()]
    t_grads = torch.autograd.grad(t_loss, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(t_loss.detach()), float(loss), atol=ATOL, rtol=0)
    want = params_from_jax(jax.tree.map(np.asarray, grads))
    assert set(want) == set(names)
    for n, g in zip(names, t_grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=ATOL, rtol=0, err_msg=n)
    return model, tree


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("name", sorted(load_model_zoo()))
def test_num_params_matches_jax(name):
    ref = load_model_zoo()[name]
    fields = {f.name for f in dataclasses.fields(tconfig.ModelConfig)}
    if ref.n_experts:  # not ported: the dense formula on its dense fields
        with pytest.raises(ValueError, match="model name"):
            tconfig.model_config(name)
        dense = tconfig.ModelConfig(**{f: getattr(ref, f) for f in fields})
        assert dense.num_params == dataclasses.replace(ref, n_experts=0).num_params
        return
    port = tconfig.model_config(name)
    assert port.num_params == ref.num_params
    model = Transformer(port, device="meta")
    assert sum(p.numel() for p in model.parameters()) == port.num_params  # no wpe in the zoo


def test_llama3_8b_config():
    cfg = tconfig.model_config("llama3_8b")
    assert cfg.num_params == 8_030_261_248
    assert (cfg.kv_heads, cfg.head_width, cfg.ff_dim, cfg.rope_theta) == (8, 128, 14336, 500000.0)
    # 4 layers: what the card trains at full width
    assert dataclasses.replace(cfg, n_layers=4).num_params == 1_923_125_248
    # learned positions add their table, which JAX's count leaves out
    learned = tconfig.model_config("test", position="learned")
    model = Transformer(learned, device="meta")
    assert sum(p.numel() for p in model.parameters()) == learned.num_params + 32 * 64
    with pytest.raises(ValueError, match="relative position"):
        tconfig.model_config("test", position="learned", doc_sep_token=0)
    with pytest.raises(ValueError, match="n_kv_heads"):
        tconfig.model_config("llama3_test", n_kv_heads=3)
    for field in (dict(position="sinusoid"), dict(norm="batch"), dict(activation="relu")):
        with pytest.raises(ValueError):
            tconfig.model_config("test", **field)


# ------------------------------------------------------------------ RoPE


@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (32, 10000.0), (128, 500000.0), (128, 10000.0)])
def test_apply_rope_matches_jax(head_dim, theta):
    want = np.asarray(jax_rope_frequencies(head_dim, theta))
    assert np.array_equal(rope_frequencies(head_dim, theta).numpy(), want)
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 16, 3, head_dim)).astype(np.float32)
    pos = np.stack([np.arange(8176, 8192), rng.integers(0, 8192, 16)]).astype(np.int32)
    pos[1, :3] = [0, 1, 4095]
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # one position vector for every row ([T]), as the training forward passes it
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos[0]), theta))
    np.testing.assert_allclose(apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), theta).numpy(), want,
                               atol=1e-5, rtol=0)
    # bf16 in, bf16 out, rotated in float32
    xb = torch.from_numpy(x).bfloat16()
    got = apply_rope(xb, torch.from_numpy(pos), theta)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_apply_rope(jnp.asarray(xb.float().numpy()), jnp.asarray(pos), theta))
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


# ------------------------------------------------------------------ the model


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unscanned"])
@pytest.mark.parametrize("name", list(MODELS))
def test_logits_loss_grads_match_jax(name, scan):
    zoo, over = MODELS[name]
    jcfg, tcfg = _configs(zoo, scan_layers=scan, **over)
    model, tree = _check_against_jax(jcfg, tcfg)
    assert ("blocks" in tree) == scan and "lm_head" in tree and model.blocks[0].mlp.gate is not None


def test_learned_positions_refuse_past_the_table():
    _, tcfg = _configs("test", position="learned")
    model = Transformer(tcfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="max_seq_len"):
        model(torch.zeros(1, 33, dtype=torch.long))
    assert model(torch.zeros(1, 32, dtype=torch.long)).shape == (1, 32, 256)


# ------------------------------------------------------------------ remat


class _CountMM(TorchDispatchMode):
    """Counts ``aten.mm`` calls: the projections' products and their grads."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _loss_grads(model, tokens):
    t = torch.from_numpy(tokens).long()
    _, loss = model(t, labels=t, train=True)
    params = [p for _, p in model.named_parameters()]
    with _CountMM() as count:
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), grads, count.n


# per layer, the products the backward recomputes. "none": 6 of a SwiGLU
# block's 7, all but wo (nothing needs its output: the recompute stops
# before it); "qkv_mlp" keeps q, k, v, wi and gate and recomputes out (the
# residual stream it feeds is the MLP norm's input); "dots" keeps all
RECOMPUTED_PER_LAYER = {"none": 6, "qkv_mlp": 1, "dots": 0}


@pytest.mark.parametrize("policy", list(RECOMPUTED_PER_LAYER))
def test_remat_policies_bit_equal_and_skip_recompute(policy):
    jcfg, tcfg = _configs("llama3_test")
    tree = _jax_params(jcfg)
    tokens = _tokens(jcfg, 5)
    loss, grads, n_plain = _loss_grads(_port_model(tcfg, tree), tokens)
    remat = _port_model(dataclasses.replace(tcfg, remat=True, remat_policy=policy), tree)
    r_loss, r_grads, n_remat = _loss_grads(remat, tokens)
    assert torch.equal(loss, r_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, r_grads))
    # no remat: dX and dW of 7 projections a layer and of the head
    assert n_plain == 2 * (7 * tcfg.n_layers + 1)
    assert n_remat - n_plain == RECOMPUTED_PER_LAYER[policy] * tcfg.n_layers


# ------------------------------------------------------------------ decay mask, digests, converter


def _port_names(jax_key: str, n_layers: int):
    """The port tensors ``params_from_jax`` makes from one JAX leaf."""
    parts = jax_key.split("/")
    leaf = "weight" if parts[-1] == "kernel" else "weight_q" if parts[-1] == "kernel_q" else parts[-1]
    if parts[0] != "blocks":
        return [".".join(parts[:-1] + [leaf])]
    return [".".join(["blocks", str(i), *parts[1:-1], leaf]) for i in range(n_layers)]


@pytest.mark.parametrize("over", [dict(), dict(position="learned", tie_embeddings=True)], ids=["llama", "learned"])
def test_weight_decay_mask_matches_jax_path_rule(over):
    jcfg, tcfg = _configs("llama3_test", **over)
    tree = _jax_params(jcfg)
    jmask = flatten_dict(jax_weight_decay_mask(tree), sep="/")
    mask = weight_decay_mask(_port_model(tcfg, tree))
    want = {n: d for key, d in jmask.items() for n in _port_names(key, tcfg.n_layers)}
    assert mask == want
    assert ("wpe.embedding" in mask) == (tcfg.position == "learned") and not mask.get("wpe.embedding", False)
    assert mask["blocks.0.mlp.gate.weight"] and not mask["blocks.1.ln_attn.scale"]


def test_tree_digests_per_jax_leaf():
    jcfg, tcfg = _configs("llama3_test")
    tree = _jax_params(jcfg, seed=4)
    learned = _jax_params(_configs("test", position="learned")[0], seed=4)
    for params, n_layers in ((tree, tcfg.n_layers), (learned, 2)):
        jax_digests = jckpt.tree_digests(params)
        port = ckpt.tree_digests(params_from_jax(params))
        flat = flatten_dict(params, sep="/")
        assert len(flat) == len(jax_digests)
        for (key, _), (_, digest) in zip(sorted(flat.items()), sorted(jax_digests.items())):
            assert sum(port[n] for n in _port_names(key, n_layers)) % 2**32 == digest, key


def _scanned_flat(tree) -> dict:
    """The ``/``-flat scanned layout of a JAX tree (an unscanned one's
    ``block_<i>`` leaves stacked on a leading layer axis)."""
    flat = flatten_dict(tree, sep="/")
    if "blocks" in tree:
        return flat
    out = {k: v for k, v in flat.items() if not k.startswith("block_")}
    n_layers = len([k for k in tree if k.startswith("block_")])
    for key in (k for k in flat if k.startswith("block_0/")):
        rest = key.split("/", 1)[1]
        out[f"blocks/{rest}"] = np.stack([flat[f"block_{i}/{rest}"] for i in range(n_layers)])
    return out


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unscanned"])
def test_converter_round_trips_float_and_int8(scan):
    jcfg, tcfg = _configs("llama3_test", scan_layers=scan)
    tree = _jax_params(jcfg, seed=6)
    scanned = _scanned_flat(tree)
    state = params_from_jax(tree)
    assert {"lm_head.weight", "blocks.0.mlp.gate.weight"} <= set(state)
    assert state["lm_head.weight"].shape == (tcfg.vocab_size, tcfg.d_model)
    back = params_to_jax(state)  # always the scanned layout
    assert set(back) == set(scanned)
    for k, v in scanned.items():
        assert np.array_equal(back[k], v), k
    # int8: JAX's quantize_params and the port's agree bit for bit, the
    # untied head and the gate included, and convert both ways
    jq = flatten_dict(jax.tree.map(np.asarray, j_quantize_params(tree)), sep="/")
    tq = flatten_dict(quantize_params(tree), sep="/")
    assert set(jq) == set(tq) and "lm_head/kernel_q" in tq and "lm_head/scale" in tq
    for k, v in jq.items():
        assert tq[k].dtype == v.dtype and np.array_equal(tq[k], v), k
    qstate = params_from_jax(tq)
    assert qstate["lm_head.weight_q"].dtype == torch.int8 and "lm_head.scale" in qstate
    assert qstate["blocks.1.mlp.gate.weight_q"].dtype == torch.int8
    qback = params_to_jax(qstate)
    want = quantize_params(scanned)
    assert set(qback) == set(want)
    for k, v in want.items():
        assert np.array_equal(qback[k], v), k
    # quantize_model (where the weights lie) = the host route
    qmodel = quantize_model(_port_model(tcfg, tree))
    assert qmodel.lm_head.weight_q.dtype == torch.int8
    for n, t in qmodel.state_dict().items():
        assert torch.equal(t, qstate[n]), n
    # and the int8 model's logits are JAX's int8 model's
    tokens = _tokens(jcfg, 9)
    jq_cfg = dataclasses.replace(jcfg, param_quant="int8")
    want_logits = np.asarray(JaxTransformer(jq_cfg).apply({"params": j_quantize_params(tree)}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = qmodel(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want_logits, atol=ATOL, rtol=0)
