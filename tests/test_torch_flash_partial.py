"""PyTorch port vs JAX reference: ``flash_partial`` and ``flash_grads``.

The sequence-parallel entries of ``ops/pallas/flash.py`` (:551 and :577):
K1-K3 at global query and key offsets with separate query and key document
ids, a slope table from the caller, f32 outputs, and (backward) the global
lse and delta from the caller. The same seeded numpy inputs go through JAX
``flash_partial`` / ``flash_grads`` in Pallas interpret mode and through the
port's wrappers, which on CPU tensors run their plain versions
(``flash_partial_reference``, ``flash_grads_reference``). A sequence of 3
shards of 64 tokens is cut into (query shard, key shard) pairs: the
diagonal, a past and a future shard, over MHA and GQA (8 query heads on 2
kv heads), ALiBi on and off, document ids that differ across the shard
boundary, and a caller's slope table (the second half of an 8-head table,
as a tensor-parallel shard holds it). The backward is given the GLOBAL
out and lse of the whole sequence, as the ring gives it, and delta both
computed and passed in. Out, lse, dq, dk and dv agree within atol 1e-5 in
float32; on the future shard the output is 0, the lse -1e30 and every grad
exactly 0 in both packages. The cases run at D = 32, and at D = 128
(MHA, and GQA with document ids) over the same three pairs.

The bf16 kernels' argument check (16-byte aligned q/k/v/do) raises on a
tensor that starts off that boundary.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_transformer_tpu.ops.pallas import flash as jflash
from zero_transformer_tpu.ops.positions import alibi_slopes
from zero_transformer_tpu_torch.ops import flash as tflash

ATOL = 1e-5
T_SHARD, N_SHARDS, B, D = 64, 3, 2, 32  # D: the head width unless a case names its own
# (query shard, key shard): the diagonal, a past shard and a future shard
PAIRS = {"diagonal": (1, 1), "past": (2, 0), "future": (0, 2)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sequence(seed, H, KVH, docs, D=D):
    rng = np.random.default_rng(seed)
    T = T_SHARD * N_SHARDS
    q, k, v = (rng.standard_normal((B, T, h, D)).astype(np.float32) for h in (H, KVH, KVH))
    do = rng.standard_normal((B, T, H, D)).astype(np.float32)
    ids = None
    if docs:
        # exclusive-cumsum ids of rows whose separators sit at a shard edge,
        # one past it, and inside shards: documents that span shard boundaries
        sep = np.zeros((B, T), np.int32)
        sep[0, [10, T_SHARD - 1, T_SHARD, 100, 2 * T_SHARD + 5]] = 1
        sep[1, [T_SHARD + 1, 2 * T_SHARD - 1]] = 1
        ids = (np.cumsum(sep, axis=1) - sep).astype(np.int32)
    return q, k, v, do, ids


def _shard(x, i):
    return None if x is None else x[:, i * T_SHARD:(i + 1) * T_SHARD]


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


CASES = [
    # (label, H, KVH, alibi, docs, slopes, D); D = 128 is 580m's head width,
    # the wgmma kernels' path on the card
    ("mha", 4, 4, True, False, False, D),
    ("gqa", 8, 2, True, False, False, D),
    ("no_alibi", 4, 4, False, False, False, D),
    ("docs", 4, 4, True, True, False, D),
    ("gqa_docs", 8, 2, True, True, False, D),
    ("slopes", 4, 4, True, False, True, D),
    ("mha_d128", 4, 4, True, False, False, 128),
    ("gqa_docs_d128", 8, 2, True, True, False, 128),
]


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_partial_and_grads_match_jax_interpret(case, pair):
    label, H, KVH, alibi, docs, with_slopes, D = case
    qi, ki = PAIRS[pair]
    q, k, v, do, ids = _sequence(len(label) + 7 * qi + ki, H, KVH, docs, D)
    slopes = np.asarray(alibi_slopes(2 * H))[H:].astype(np.float32) if with_slopes else None
    scale = 1.0 / D**0.5
    common = dict(causal=True, alibi=alibi, softmax_scale=scale, q_offset=qi * T_SHARD,
                  kv_offset=ki * T_SHARD)
    qs, ks, vs = _shard(q, qi), _shard(k, ki), _shard(v, ki)
    q_ids, k_ids = _shard(ids, qi), _shard(ids, ki)

    # forward: one shard pair, normalised by its own softmax sum
    j_out, j_lse = jflash.flash_partial(
        _j(qs), _j(ks), _j(vs), **common, slopes=None if slopes is None else _j(slopes.reshape(-1, 1)),
        q_ids=_j(q_ids), k_ids=_j(k_ids), interpret=True)
    t_out, t_lse = tflash.flash_partial(_t(qs), _t(ks), _t(vs), **common, slopes=_t(slopes),
                                        q_ids=_t(q_ids), k_ids=_t(k_ids))
    assert t_out.dtype == t_lse.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[..., 0], atol=ATOL, rtol=0)
    if pair == "future":  # no key of the shard is visible: _INIT_M, o = 0
        assert np.all(t_out.numpy() == 0) and np.all(t_lse.numpy() == tflash.INIT_M)

    # backward against the GLOBAL out and lse of the whole sequence
    full = tflash.flash_reference(_t(q), _t(k), _t(v), causal=True, alibi=alibi, q_ids=_t(ids),
                                  k_ids=_t(ids), slopes=_t(slopes))
    o_glob, lse_glob = _shard(full[0].numpy(), qi), full[1].numpy()[:, :, qi * T_SHARD:(qi + 1) * T_SHARD]
    dos = _shard(do, qi)
    delta = (dos * o_glob).sum(-1).transpose(0, 2, 1).copy()  # [B, H, t]
    for given in (None, delta):
        j_grads = jflash.flash_grads(
            _j(qs), _j(ks), _j(vs), _j(o_glob), _j(lse_glob[..., None]), _j(dos), **common,
            slopes=None if slopes is None else _j(slopes.reshape(-1, 1)),
            delta=None if given is None else _j(given[..., None]), q_ids=_j(q_ids), k_ids=_j(k_ids),
            interpret=True)
        t_grads = tflash.flash_grads(_t(qs), _t(ks), _t(vs), _t(o_glob), _t(lse_glob), _t(dos), **common,
                                     slopes=_t(slopes), delta=_t(given), q_ids=_t(q_ids), k_ids=_t(k_ids))
        for name, a, b in zip(("dq", "dk", "dv"), t_grads, j_grads):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=name)
            if pair == "future":
                assert np.all(a.numpy() == 0) and np.all(np.asarray(b) == 0), name


def test_partial_shards_merge_to_full_attention():
    """The ring's merge of the three key shards' partials by their lse is
    the full causal attention of the query shard (flash_reference)."""
    H, KVH = 8, 2
    q, k, v, _, ids = _sequence(11, H, KVH, True)
    full_o, full_lse = tflash.flash_reference(_t(q), _t(k), _t(v), causal=True, alibi=True,
                                              doc_ids=_t(ids))
    for qi in range(N_SHARDS):
        m = torch.full((B, H, T_SHARD), tflash.INIT_M)
        norm = torch.zeros(B, H, T_SHARD)
        acc = torch.zeros(B, T_SHARD, H, D)
        for ki in range(N_SHARDS):
            o_i, lse_i = tflash.flash_partial(_t(_shard(q, qi)), _t(_shard(k, ki)), _t(_shard(v, ki)),
                                              causal=True, alibi=True, q_offset=qi * T_SHARD,
                                              kv_offset=ki * T_SHARD, q_ids=_t(_shard(ids, qi)),
                                              k_ids=_t(_shard(ids, ki)))
            m_new = torch.maximum(m, lse_i)
            w_prev, w_i = torch.exp(m - m_new), torch.exp(lse_i - m_new)
            norm = norm * w_prev + w_i
            acc = acc * w_prev.transpose(1, 2)[..., None] + o_i * w_i.transpose(1, 2)[..., None]
            m = m_new
        out = acc / norm.transpose(1, 2)[..., None]
        np.testing.assert_allclose(out.numpy(), _shard(full_o.numpy(), qi), atol=ATOL, rtol=0)
        np.testing.assert_allclose((m + torch.log(norm)).numpy(),
                                   full_lse.numpy()[:, :, qi * T_SHARD:(qi + 1) * T_SHARD], atol=ATOL, rtol=0)


def test_partial_wrappers_refuse_what_the_kernels_cannot_take():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 4, 32)
    ids = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="both or neither"):
        tflash.flash_partial(q, k, k, causal=True, alibi=True, q_ids=ids)
    with pytest.raises(ValueError, match="k_ids"):
        tflash.flash_partial(q, k, k, causal=True, alibi=True, q_ids=ids, k_ids=ids[:, :4])
    with pytest.raises(ValueError, match="one value per query head"):
        tflash.flash_partial(q, k, k, causal=True, alibi=True, slopes=torch.ones(3))
    meta = torch.zeros(1, 8, 4, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tflash.flash_partial(meta, meta, meta, causal=True, alibi=True)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tflash.flash_grads(meta, meta, meta, meta, torch.zeros(1, 4, 8, device="meta"), meta,
                           causal=True, alibi=True)


def test_bf16_backward_refuses_misaligned_tensors():
    """The bf16 kernels copy 16 bytes at a time: a q/k/v/do view that starts
    one bf16 element past a 16-byte boundary is refused, before any launch."""
    buf = torch.zeros(1 + 8 * 4 * 128, dtype=torch.bfloat16)
    aligned = buf[:-1].view(1, 8, 4, 128)
    assert aligned.data_ptr() % 16 == 0
    tflash.check_aligned(aligned, aligned, aligned, aligned)
    shifted = buf[1:].view(1, 8, 4, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tflash.check_aligned(aligned, shifted, aligned, aligned)
