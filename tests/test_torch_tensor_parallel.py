"""PyTorch port vs JAX reference: tensor-parallel decoding at TP 2.

The ``test`` model (GPT, ALiBi: rank 1 holds heads 2-3 and attends with
their slopes), ``llama3_test`` (RoPE, GQA 4 on 2 kv heads: one kv head a
rank) and ``test`` with int8 weights, in float32 with JAX's init times 4
on both sides. One world of 2 gloo processes (``tests/_torch_dist.py``,
its 120 s deadline) splits each model over its ``TensorGroup``
(``shard_for_inference`` of the whole converted state dict); JAX runs the
same weights through ``serve_mesh(2)`` and ``shard_for_inference`` on its
8-device CPU mesh:

- greedy ``generate`` equals JAX ``generate(..., mesh=serve_mesh(2))``
  (``tests/test_inference.py:326``; int8 weights, ``tests/test_quant.py:160``);
- the prefill's last logits are within 1e-5 of JAX's under the mesh (:394);
- each rank holds half the heads, features and vocabulary, and its cache
  ``KVH / 2`` kv heads;
- the shards concatenated in rank order are the whole tensors;
- ``scatter_for_inference`` loads each rank's shard from rank 0's whole
  tree alone, and refuses on every rank a tree that lacks a name;
- a head count that 2 does not divide raises, naming the heads, before any
  weight loads (JAX warns and replicates its cache instead);
- K4's plain version and ``dot_product_attention`` take ``slopes=``: a
  head range's slopes hold against JAX's kernels with the same override,
  and the unsliced table does not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from test_torch_generate import make_pair
from zero_transformer_tpu.inference import decode_model as j_decode_model
from zero_transformer_tpu.inference import generate as j_generate
from zero_transformer_tpu.inference import init_cache as j_init_cache
from zero_transformer_tpu.inference import prefill as j_prefill
from zero_transformer_tpu.inference import serve_mesh as j_serve_mesh
from zero_transformer_tpu.inference import shard_for_inference as j_shard
from zero_transformer_tpu.inference.sampling import SamplingConfig as JaxSampling
from zero_transformer_tpu.ops import attention as jattn
from zero_transformer_tpu.ops.pallas import paged_attention as jpaged
from zero_transformer_tpu.ops.positions import alibi_slopes as j_alibi_slopes
from zero_transformer_tpu.utils.jax_compat import set_mesh
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.inference import shard_for_inference
from zero_transformer_tpu_torch.models.gpt import Transformer, tp_split_dim
from zero_transformer_tpu_torch.ops import attention as tattn
from zero_transformer_tpu_torch.ops import paged_attention as tpaged
from zero_transformer_tpu_torch.ops.positions import alibi_slopes
from zero_transformer_tpu_torch.parallel.mesh import TensorGroup

WORLD, B, T, NEW, CACHE = 2, 2, 8, 12, 32
CASES = {  # name: (zoo, weights)
    "gpt_alibi": ("test", "none"),
    "llama_gqa": ("llama3_test", "none"),
    "gpt_int8_weights": ("test", "int8"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _prompt(name):
    return np.random.default_rng(sorted(CASES).index(name) + 3).integers(1, 250, (B, T)).astype(np.int64)


def _pair(name):
    zoo, weights = CASES[name]
    return make_pair(zoo, weights=weights)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    payload = {}
    for name, (zoo, weights) in CASES.items():
        _, _, model = _pair(name)
        payload[name] = dict(zoo=zoo, over=dict(dropout=0.0, compute_dtype="float32", param_quant=weights),
                             state={n: t.numpy() for n, t in model.state_dict().items()},
                             prompt=_prompt(name), new=NEW, cache_len=CACHE)
    return _torch_dist.run_world("tp_generate_cases", payload, tmp_path_factory.mktemp("tp"), world=WORLD)


def _jax_tp(name):
    """JAX on serve_mesh(2): greedy tokens and the prefill's last logits."""
    jcfg, params, _ = _pair(name)
    model = j_decode_model(jcfg, CACHE)
    mesh = j_serve_mesh(WORLD)
    sharded = j_shard(model, params, mesh)
    prompt = jnp.asarray(_prompt(name), jnp.int32)
    tokens = j_generate(model, sharded, prompt, NEW, jax.random.PRNGKey(1), JaxSampling(greedy=True), mesh=mesh)
    with set_mesh(mesh):
        logits, _ = j_prefill(model, sharded, prompt, j_init_cache(model, B, mesh=mesh))
    return np.asarray(tokens), np.asarray(logits)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp2_generate_matches_jax_serve_mesh(ranks, name, devices):
    tokens, _ = _jax_tp(name)
    for r in ranks:
        np.testing.assert_array_equal(r[name]["tokens"], tokens)
    assert len(set(tokens[0].tolist())) > 1  # the rows vary: the comparison is not of one repeated token


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp2_prefill_logits_match_jax(ranks, name, devices):
    _, logits = _jax_tp(name)
    for r in ranks:
        np.testing.assert_allclose(r[name]["logits"], logits, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_holds_half(ranks, name):
    zoo, weights = CASES[name]
    cfg = tconfig.model_config(zoo)
    whole = {n: tuple(t.shape) for n, t in _pair(name)[2].state_dict().items()}
    for r in ranks:
        assert r[name]["pool"][2] == cfg.kv_heads // WORLD
        for n, shape in r[name]["shapes"].items():
            dim = tp_split_dim(n)
            want = list(whole[n])
            if dim is not None:
                want[dim] //= WORLD
            assert list(shape) == want, n


@pytest.mark.parametrize("name", sorted(CASES))
def test_scatter_from_rank0_loads_each_rank_its_shard(ranks, name):
    first = next(iter(_pair(name)[2].state_dict()))
    for r in ranks:
        assert r[name]["scattered_equal"]
        # rank 0's tree lacks its first name: every rank refuses, before any weight moves
        assert r[name]["short_tree_error"] is not None and first in r[name]["short_tree_error"]


def gather_shards(shards) -> dict:
    """The whole state dict from every rank's shard, in rank order (the
    inverse of ``shard_for_inference``)."""
    return {name: (torch.cat([s[name] for s in shards], dim=tp_split_dim(name))
                   if tp_split_dim(name) is not None else shards[0][name])
            for name in shards[0]}


@pytest.mark.parametrize("name", sorted(CASES))
def test_shards_concatenate_to_the_whole(name):
    _, _, model = _pair(name)
    state = model.state_dict()
    shards = []
    for rank in range(WORLD):
        group = TensorGroup(rank=rank, size=WORLD, backend="none", device=torch.device("cpu"))
        shard = shard_for_inference(model, state, group)
        local = Transformer(model.cfg, device="cpu", tensor_group=group)
        local.load_state_dict(shard)  # the shard fits the rank's model exactly
        shards.append(shard)
    back = gather_shards(shards)
    assert sorted(back) == sorted(state)
    for n, t in state.items():
        assert torch.equal(back[n], t), n
    split = [n for n in state if tp_split_dim(n) is not None]
    assert any(n.endswith("attn.out.weight" if model.cfg.param_quant == "none" else "attn.out.weight_q")
               for n in split)
    if model.cfg.param_quant == "int8":  # a row split keeps its per-channel scale whole
        assert tp_split_dim("blocks.0.attn.out.scale") is None and tp_split_dim("blocks.0.attn.query.scale") == 0


def test_indivisible_heads_raise_before_weights():
    from zero_transformer_tpu_torch import serve

    cfg = dataclasses.replace(tconfig.model_config("test"), d_model=48, n_heads=6, n_kv_heads=3)
    group = TensorGroup(rank=0, size=2, backend="none", device=torch.device("cpu"))
    with pytest.raises(ValueError, match="kv heads 3"):
        Transformer(cfg, device="cpu", tensor_group=group)
    # the CLI refuses before reading --params (the file does not exist)
    args = serve.build_parser().parse_args(["--model", "byte_2m", "--params", "missing.npz", "--tensor", "4",
                                            "--device", "cpu"])
    with pytest.raises(ValueError, match="query heads 6"):
        serve.check_tensor_args(args)
    with pytest.raises(ValueError, match="quantize the whole model"):
        from zero_transformer_tpu_torch.models.quant import quantize_model

        quantize_model(Transformer(tconfig.model_config("test"), device="cpu", tensor_group=group))


# (name, B, T, H, KVH, page, n_blocks, offsets, int8)
SLOPE_CASES = [
    ("decode_heads_6_of_12", 3, 1, 12, 12, 8, 6, [0, 9, 40], False),
    ("verify_gqa_heads_4_of_8", 2, 4, 8, 4, 8, 6, [5, 33], False),
    ("int8_decode_heads_6_of_12", 3, 1, 12, 12, 8, 6, [2, 17, 44], True),
]


@pytest.mark.parametrize("case", SLOPE_CASES, ids=[c[0] for c in SLOPE_CASES])
def test_paged_slopes_offset_matches_jax(case):
    from test_torch_attention import _paged_inputs

    _, B, T, H, KVH, page, n_blocks, offs, int8 = case
    rng = np.random.default_rng(len(case[0]) + 31)
    hl, kvl = H // 2, KVH // 2  # rank 1's heads of a TP 2 split
    q, kp, vp, (ks, vs), table, offsets = _paged_inputs(rng, B, T, hl, kvl, 16, page, n_blocks, offs, int8=int8)
    slopes = alibi_slopes(H)[hl:]
    want = jpaged.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table), jnp.asarray(offsets),
        causal=T > 1, alibi=True, interpret=True, slopes=j_alibi_slopes(H)[hl:],
        k_scale=None if ks is None else jnp.asarray(ks), v_scale=None if vs is None else jnp.asarray(vs))
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(table),
            torch.from_numpy(offsets))
    scales = dict(k_scale=None if ks is None else torch.from_numpy(ks),
                  v_scale=None if vs is None else torch.from_numpy(vs))
    got = tpaged.paged_attention(*args, causal=T > 1, alibi=True, slopes=slopes, **scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # the slopes of heads 0 .. H/2 (the unsliced table's head) miss the bar
    wrong = tpaged.paged_reference(*args, causal=T > 1, alibi=True, slopes=alibi_slopes(H)[:hl], **scales)
    assert float((wrong - got).abs().max()) > 1e-3


def test_dot_product_attention_slopes_match_jax():
    rng = np.random.default_rng(41)
    Bq, Tq, S, H, KVH, D = 2, 8, 24, 6, 3, 16
    q = rng.standard_normal((Bq, Tq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((Bq, S, KVH, D)).astype(np.float32) for _ in range(2))
    offs = np.asarray([4, 16], np.int32)
    seg = (np.arange(S)[None, :] < (offs[:, None] + Tq)).astype(np.int32)
    j_slopes = j_alibi_slopes(2 * H)[H:]
    want = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, alibi=True,
                               q_offset=jnp.asarray(offs), segment_ids=jnp.asarray(seg), slopes=j_slopes)
    got = tattn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
                                      alibi=True, q_offset=torch.from_numpy(offs), segment_ids=torch.from_numpy(seg),
                                      slopes=alibi_slopes(2 * H)[H:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # the int offset path (one window for every row) takes the override too
    want0 = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k[:, :Tq]), jnp.asarray(v[:, :Tq]), causal=True,
                                alibi=True, slopes=j_slopes)
    got0 = tattn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k[:, :Tq]),
                                       torch.from_numpy(v[:, :Tq]), causal=True, alibi=True,
                                       slopes=alibi_slopes(2 * H)[H:])
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), atol=1e-5, rtol=0)
