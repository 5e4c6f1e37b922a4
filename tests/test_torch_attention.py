"""PyTorch port vs JAX reference: attention ops and the plain versions of
the CUDA kernels.

Same inputs (numpy, seeded) go through the JAX function and the port's
counterpart on the CPU, in float32:

- ``xla_attention`` (the reference path of both packages), atol 1e-5;
- the flash kernel's plain version vs JAX ``flash_serving`` in Pallas
  interpret mode, atol 1e-5;
- the paged kernel's plain version vs JAX ``paged_attention`` in interpret
  mode, with ragged tables, a trash row, a NaN-poisoned row and offsets on
  page and chunk edges, atol 1e-5; over float32 pools and over int8 pools
  with float32 scales (the TPU kernel's int8 branch).

Then the CPU dispatch contract: each gate declines CPU tensors and
``impl="flash"`` raises there.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_transformer_tpu.ops import attention as jattn
from zero_transformer_tpu.ops import positions as jpos
from zero_transformer_tpu.ops.pallas import flash as jflash
from zero_transformer_tpu.ops.pallas import paged_attention as jpaged
from zero_transformer_tpu_torch.ops import attention as tattn
from zero_transformer_tpu_torch.ops import flash as tflash
from zero_transformer_tpu_torch.ops import flash_attention as tfa
from zero_transformer_tpu_torch.ops import paged_attention as tpaged
from zero_transformer_tpu_torch.ops import positions as tpos

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n_heads", [1, 4, 6, 8, 12, 16, 24])
def test_alibi_slopes_match(n_heads):
    assert tpos.alibi_slopes_list(n_heads) == jpos.alibi_slopes_list(n_heads)
    assert tpos.NEG_INF == jpos.NEG_INF == -1e10


# (name, B, Tq, Tkv, H, KVH, alibi, causal, per_row_offsets, valid)
XLA_CASES = [
    ("per_row_offsets", 3, 8, 32, 4, 4, True, True, [0, 7, 24], False),
    ("validity_mask", 2, 8, 32, 4, 4, True, True, [3, 16], True),
    ("alibi_12_heads", 2, 16, 16, 12, 12, True, True, None, False),
    ("gqa", 2, 8, 24, 8, 2, True, True, [4, 16], True),
    ("gqa_no_alibi", 2, 6, 6, 6, 3, False, True, None, False),
    ("scalar_offset_decode", 2, 1, 20, 12, 12, True, False, 9, True),
]


@pytest.mark.parametrize("case", XLA_CASES, ids=[c[0] for c in XLA_CASES])
def test_xla_attention_matches_jax(case):
    _, B, Tq, Tkv, H, KVH, alibi, causal, offs, valid = case
    rng = np.random.default_rng(len(case[0]))
    D = 16
    q, k, v = _rand(rng, B, Tq, H, D), _rand(rng, B, Tkv, KVH, D), _rand(rng, B, Tkv, KVH, D)
    seg = None
    if valid:
        lens = rng.integers(Tq, Tkv + 1, size=B)
        seg = (np.arange(Tkv)[None, :] < lens[:, None]).astype(np.int32)
    if isinstance(offs, list):
        j_off, t_off = jnp.asarray(offs, jnp.int32), torch.tensor(offs, dtype=torch.int32)
    else:
        j_off = t_off = offs or 0
    want = jattn.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, alibi=alibi,
        q_offset=j_off, segment_ids=None if seg is None else jnp.asarray(seg),
    )
    got = tattn.xla_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        alibi=alibi, q_offset=t_off, segment_ids=None if seg is None else torch.from_numpy(seg),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_xla_attention_doc_ids_match_jax():
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, 12, 4, 8), _rand(rng, 2, 12, 4, 8), _rand(rng, 2, 12, 4, 8)
    docs = np.array([[0] * 5 + [1] * 7, [0] * 12], np.int32)
    want = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               alibi=True, doc_ids=jnp.asarray(docs))
    got = tattn.xla_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=True, alibi=True, doc_ids=torch.from_numpy(docs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# (name, B, T, S, H, KVH, offsets, valid_lens)
FLASH_CASES = [
    ("chunk_windows", 3, 16, 64, 12, 12, [0, 16, 48], [16, 32, 64]),
    ("ragged_validity", 2, 16, 64, 4, 4, [8, 40], [20, 56]),
    ("gqa", 2, 8, 32, 8, 2, [0, 24], [8, 32]),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_plain_matches_jax_flash_serving(case):
    _, B, T, S, H, KVH, offs, lens = case
    rng = np.random.default_rng(len(case[0]) + 11)
    D = 16
    q, k, v = _rand(rng, B, T, H, D), _rand(rng, B, S, KVH, D), _rand(rng, B, S, KVH, D)
    seg = (np.arange(S)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    want = jflash.flash_serving(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, alibi=True,
        q_offset=jnp.asarray(offs, jnp.int32), segment_ids=jnp.asarray(seg), interpret=True,
    )
    got, lse = tflash.flash_serving(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
        alibi=True, q_offset=torch.tensor(offs, dtype=torch.int32),
        segment_ids=torch.from_numpy(seg), return_lse=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # the lse the kernel can return: JAX _fwd's second output
    _, want_lse = jflash._fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, True, 1.0 / D**0.5, T, S, True,
        q_offset=jnp.asarray(offs, jnp.int32), segment_ids=jnp.asarray(seg),
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=1e-4, rtol=0)


def _paged_inputs(rng, B, T, H, KVH, D, page, n_blocks, offsets, trash_row=None, nan_row=None,
                  int8=False):
    n_pages = B * n_blocks + 1
    q = _rand(rng, B, T, H, D)
    if int8:
        # random int8 pages and scales as tests/test_paged_kernel.py draws
        # them; the trash page 0 keeps scale 0, and some positions are all zero
        kp, vp = (rng.integers(-127, 128, (n_pages, page, KVH, D)).astype(np.int8) for _ in range(2))
        scales = [rng.uniform(1e-3, 2e-2, (n_pages, page, KVH, 1)).astype(np.float32) for _ in range(2)]
        for pool, sc in zip((kp, vp), scales):
            sc[0] = 0.0
            pool[1:, ::5] = 0
    else:
        kp, vp = _rand(rng, n_pages, page, KVH, D), _rand(rng, n_pages, page, KVH, D)
        scales = [None, None]
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((B, n_blocks), np.int32)
    used = 0
    for b, off in enumerate(offsets):  # ragged: each row maps only what it needs
        need = min(n_blocks, -(-(off + T) // page))
        table[b, :need] = perm[used:used + need]
        used += need
    if trash_row is not None:
        table[trash_row] = 0
    if nan_row is not None:
        q[nan_row] = np.nan
    return q, kp, vp, scales, table, np.asarray(offsets, np.int32)


# (name, B, T, H, KVH, page, n_blocks, offsets, trash_row, nan_row, int8)
PAGED_CASES = [
    ("page_edges", 4, 1, 4, 4, 8, 6, [0, 7, 8, 47], None, None, False),
    ("chunk_edges_alibi12", 3, 1, 12, 12, 8, 8, [15, 16, 63], None, None, False),
    ("trash_and_nan_rows", 4, 1, 4, 4, 8, 6, [0, 12, 30, 5], 0, 2, False),
    ("verify_window_gqa", 2, 4, 8, 2, 8, 6, [9, 40], None, None, False),
    ("int8_page_edges", 4, 1, 4, 4, 8, 6, [0, 7, 8, 47], None, None, True),
    ("int8_trash_nan_ragged", 4, 1, 4, 4, 8, 6, [0, 12, 30, 5], 0, 2, True),
    ("int8_verify_T3_alibi12", 3, 3, 12, 12, 8, 8, [15, 16, 61], None, None, True),
    ("int8_verify_T3_gqa", 2, 3, 8, 2, 8, 6, [9, 40], None, None, True),
]


@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_plain_matches_jax_paged_attention(case):
    _, B, T, H, KVH, page, n_blocks, offs, trash_row, nan_row, int8 = case
    rng = np.random.default_rng(len(case[0]) + 5)
    q, kp, vp, (ks, vs), table, offsets = _paged_inputs(
        rng, B, T, H, KVH, 16, page, n_blocks, offs, trash_row, nan_row, int8,
    )
    want = jpaged.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(offsets), causal=T > 1, alibi=True, interpret=True,
        k_scale=None if ks is None else jnp.asarray(ks), v_scale=None if vs is None else jnp.asarray(vs),
    )
    got = tpaged.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(offsets), causal=T > 1, alibi=True,
        k_scale=None if ks is None else torch.from_numpy(ks), v_scale=None if vs is None else torch.from_numpy(vs),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if nan_row is not None:
        assert np.isnan(got[nan_row].numpy()).all()


def test_gates_decline_cpu_and_flash_raises():
    q = torch.zeros(1, 16, 4, 64)
    k = v = torch.zeros(1, 64, 4, 64)
    assert not tfa.supported(q, k, v, causal=True, alibi=True)
    assert "CUDA" in tfa.decline_reason(q, k, v, causal=True, alibi=True)
    with pytest.raises(NotImplementedError):
        tattn.dot_product_attention(q, k, v, causal=True, alibi=True, impl="flash")
    # auto on the CPU is the reference path
    out = tattn.dot_product_attention(q, k, v, causal=True, alibi=True, impl="auto")
    ref = tattn.xla_attention(q, k, v, causal=True, alibi=True)
    assert torch.equal(out, ref)
    # off the CPU nothing falls back to the reference: a tensor that is not
    # on the CPU (a meta tensor here, a CUDA one on the card) takes the
    # kernel or raises, under "auto" as under "flash"
    qm, km = q.to("meta"), k.to("meta")
    with pytest.raises(NotImplementedError, match="CUDA"):
        tattn.dot_product_attention(qm, km, km, causal=True, alibi=True, impl="auto")
    pool = torch.zeros(3, 16, 4, 64, device="meta")
    table = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tpaged.paged_attention(qm[:, :1], pool, pool, table, torch.zeros(1, dtype=torch.int32),
                               causal=False, alibi=True)


def test_paged_int8_pools_need_scales():
    q = torch.zeros(1, 1, 4, 16)
    pool = torch.zeros(3, 8, 4, 16, dtype=torch.int8)
    table = torch.zeros(1, 2, dtype=torch.int32)
    offs = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="k_scale/v_scale"):
        tpaged.paged_attention(q, pool, pool, table, offs, causal=False, alibi=True)
    bad = torch.zeros(3, 8, 4, 16)  # a scale per element, not per (position, head)
    with pytest.raises(ValueError, match="scale pools"):
        tpaged.paged_attention(q, pool, pool, table, offs, causal=False, alibi=True, k_scale=bad, v_scale=bad)
    # the trash page with scale 0 reads as zeros: attention over it is 0
    sc = torch.zeros(3, 8, 4, 1)
    out = tpaged.paged_attention(q + 1, pool + 5, pool + 5, table, offs, causal=False, alibi=True,
                                 k_scale=sc, v_scale=sc)
    assert torch.equal(out, torch.zeros_like(out))
    # off the CPU an int8 pool takes the int8 kernel or raises, never the plain path
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tpaged.paged_attention(q.to("meta"), pool.to("meta"), pool.to("meta"), table, offs, causal=False,
                               alibi=True, k_scale=sc.to("meta"), v_scale=sc.to("meta"))


def test_gate_and_wrapper_signatures_match():
    gate = inspect.signature(tfa.supported).parameters
    wrap = inspect.signature(tfa.flash_attention).parameters
    why = inspect.signature(tfa.decline_reason).parameters
    assert list(gate) == list(wrap) == list(why)
    assert all(gate[n].kind == wrap[n].kind == why[n].kind for n in gate)
