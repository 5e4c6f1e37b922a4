"""The paged decode kernel's split plan and its split-then-merge arithmetic,
on the CPU.

``csrc/paged_attention.cu`` splits each row's keys over the CTAs of one
thread-block cluster (``split_plan``). Inside a CTA every key slot of a step
(a group of lanes) keeps its own online softmax (m, l, acc) over the keys
it takes, tile after tile; the slots merge, then the cluster merges the
splits in split order: out = sum_s e^(m_s - M) o_s / sum_s e^(m_s - M) l_s,
0 where no key was visited. ``split_merge_emulation`` below does the same
arithmetic in float32 torch. It must equal the plain version
``paged_reference`` and JAX ``paged_attention`` in Pallas interpret mode
within 1e-5 on the same numpy-seeded inputs: over splits that see no key,
a NaN-poisoned row, a trash-page row, a GQA verify window and int8 pools
with zero-scale rows. Then the wrapper's 16-byte alignment check.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_transformer_tpu.ops.pallas import paged_attention as jpaged
from zero_transformer_tpu_torch.ops import paged_attention as tpaged
from zero_transformer_tpu_torch.ops import flash as tflash
from zero_transformer_tpu_torch.ops.positions import NEG_INF, alibi_slopes

ATOL = 1e-5
INIT_M = -1e30
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("page", [1, 2, 4, 8, 16, 32, 64])
def test_split_plan_covers_every_key_once(page):
    for S in sorted({16, 17 * 16, 48, 64, 100 * 16, 1024, 1040, 4096, 8000, 8192} | set(range(16, 257, 16))):
        if S % page:
            continue
        per, n = tpaged.split_plan(S // page, page)
        assert 1 <= n <= tpaged.MAX_SPLITS
        assert per % page == 0 and per >= -(-S // tpaged.MAX_SPLITS)
        # splits [s * per, (s + 1) * per) clipped to S: each key once, none empty
        covered = np.zeros(S, np.int64)
        for s in range(n):
            covered[s * per:min((s + 1) * per, S)] += 1
        assert (covered == 1).all() and (n - 1) * per < S


def test_split_plan_serving_and_long_shapes():
    assert tpaged.split_plan(64, 16) == (128, 8)  # 125m serving: cache 1024, page 16
    assert tpaged.split_plan(512, 16) == (1024, 8)  # S 8192
    assert tpaged.split_plan(1, 16) == (16, 1)
    assert tpaged.split_plan(3, 16) == (16, 3)


def split_merge_emulation(q, k_pool, v_pool, block_table, q_offset, *, causal, alibi, kps, k_scale=None,
                          v_scale=None):
    """The kernel's arithmetic in float32: scores in log2 units (the scale,
    slopes and mask value times log2 e, then exp2), per split ``kps`` key
    slots each run an online softmax over keys slot, slot + kps, ... of the
    split; the slots merge, then the splits merge in order. Biases in the
    gather path's order; keys at or past q_offset + T are not visited."""
    B, T, H, D = q.shape
    _, page, KVH, _ = k_pool.shape
    G, n_blocks = H // KVH, block_table.shape[1]
    S = n_blocks * page
    per, n = tpaged.split_plan(n_blocks, page)
    offs = q_offset.long()
    k, v, _ = tpaged.gather_window(k_pool, v_pool, block_table, offs, T, k_scale=k_scale, v_scale=v_scale,
                                   dtype=q.dtype)
    k, v = k.float(), v.float()  # [B, S, KVH, D]
    # rows of a kv head: rr = t * G + g, query head kvh * G + g
    qr = q.float().reshape(B, T, KVH, G, D).permute(0, 2, 1, 3, 4).reshape(B, KVH, T * G, D)
    s = torch.einsum("bkrd,bskd->bkrs", qr, k) * (D**-0.5 * LOG2E)
    t = torch.arange(T).repeat_interleave(G)
    dist = offs[:, None, None] + t[None, :, None] - torch.arange(S)[None, None, :]  # [B, R, S]
    if alibi:
        slope = alibi_slopes(H).reshape(KVH, G).repeat(1, T) * LOG2E  # [KVH, R]
        bias = -slope[None, :, :, None] * dist.clamp(min=0)[:, None].float()
        if causal:
            bias = bias + torch.where(dist >= 0, 0.0, NEG_INF * LOG2E)[:, None]
        s = s + bias
    elif causal:
        s = s + torch.where(dist >= 0, 0.0, NEG_INF * LOG2E)[:, None]
    n_keys = torch.clamp(offs + T, max=S)

    R = T * G
    m = torch.full((B, KVH, R, n, kps), INIT_M)
    l = torch.zeros(B, KVH, R, n, kps)
    acc = torch.zeros(B, KVH, R, n, kps, D)
    splits = torch.arange(n)[:, None]
    for step in range(-(-per // kps)):
        local = step * kps + torch.arange(kps)[None, :]  # [1, kps]
        pos = splits * per + local  # [n, kps]
        valid = (local < per)[None] & (pos[None] < n_keys[:, None, None])  # [B, n, kps]
        at = pos.clamp(max=S - 1).reshape(-1)
        x = s[..., at].reshape(B, KVH, R, n, kps)
        vv = v[:, at].reshape(B, n, kps, KVH, D).permute(0, 3, 1, 2, 4)[:, :, None]  # [B, KVH, 1, n, kps, D]
        mn = torch.fmax(m, x)  # a NaN score keeps m and poisons l and acc
        a, p = torch.exp2(m - mn), torch.exp2(x - mn)
        ok = valid[:, None, None]
        l = torch.where(ok, l * a + p, l)
        acc = torch.where(ok[..., None], acc * a[..., None] + p[..., None] * vv, acc)
        m = torch.where(ok, mn, m)
    # the slots of a split, then the splits in order
    ms = m.amax(-1)
    w = torch.exp2(m - ms[..., None])
    ls, os_ = (w * l).sum(-1), (w[..., None] * acc).sum(-2)
    mx = torch.full(ms.shape[:-1], INIT_M)
    for i in range(n):
        mx = torch.fmax(mx, ms[..., i])
    num, den = torch.zeros(B, KVH, R, D), torch.zeros(B, KVH, R)
    for i in range(n):
        wt = torch.exp2(ms[..., i] - mx)
        num = num + wt[..., None] * os_[..., i, :]
        den = den + wt * ls[..., i]
    out = torch.where(den[..., None] == 0, torch.zeros(()), num / den[..., None])
    return out.reshape(B, KVH, T, G, D).permute(0, 2, 1, 3, 4).reshape(B, T, H, D)


def _inputs(seed, B, T, H, KVH, D, page, n_blocks, offsets, trash_row=None, nan_row=None, int8=False):
    rng = np.random.default_rng(seed)
    n_pages = B * n_blocks + 1
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    if int8:
        kp, vp = (rng.integers(-127, 128, (n_pages, page, KVH, D)).astype(np.int8) for _ in range(2))
        scales = [rng.uniform(1e-3, 2e-2, (n_pages, page, KVH, 1)).astype(np.float32) for _ in range(2)]
        for sc in scales:
            sc[0] = 0.0  # the trash page
            sc[1:, ::3] = 0.0  # zero-scale rows: every third position of every page
    else:
        kp = rng.standard_normal((n_pages, page, KVH, D)).astype(np.float32)
        vp = rng.standard_normal((n_pages, page, KVH, D)).astype(np.float32)
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
CASES = [
    # S 128 in 8 splits of 16: row 0 sees split 0 only, row 1 two splits
    ("empty_splits", 3, 1, 4, 4, 8, 16, [0, 20, 127], None, None, False),
    ("nan_and_trash_rows", 4, 1, 4, 4, 8, 16, [5, 40, 77, 127], 0, 2, False),
    # T 5, G 3: the causal mask inside the window, split edges at 16 and 32
    ("gqa_verify_T5_G3", 2, 5, 6, 2, 8, 12, [9, 27], None, None, False),
    ("page_4_odd_splits", 3, 1, 4, 2, 4, 40, [19, 20, 155], None, None, False),
    ("int8_zero_scale_rows", 3, 1, 4, 4, 8, 16, [0, 47, 127], None, None, True),
    ("int8_gqa_T3_trash_nan", 4, 3, 8, 2, 8, 16, [1, 30, 64, 120], 1, 3, True),
]


@pytest.mark.parametrize("kps", [4, 16])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_merge_matches_reference_and_jax(case, kps):
    _, B, T, H, KVH, page, n_blocks, offs, trash_row, nan_row, int8 = case
    q, kp, vp, (ks, vs), table, offsets = _inputs(len(case[0]) + kps, B, T, H, KVH, 16, page, n_blocks, offs,
                                                  trash_row, nan_row, int8)
    tt = [None if x is None else torch.from_numpy(x) for x in (q, kp, vp, table, offsets, ks, vs)]
    kw = dict(causal=T > 1, alibi=True, k_scale=tt[5], v_scale=tt[6])
    emu = split_merge_emulation(*tt[:5], kps=kps, **kw)
    ref = tpaged.paged_reference(*tt[:5], **kw)
    want = jpaged.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table), jnp.asarray(offsets),
        causal=T > 1, alibi=True, interpret=True,
        k_scale=None if ks is None else jnp.asarray(ks), v_scale=None if vs is None else jnp.asarray(vs),
    )
    np.testing.assert_allclose(emu.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(emu.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if nan_row is not None:
        assert torch.isnan(emu[nan_row]).all() and not torch.isnan(emu[[b for b in range(B) if b != nan_row]]).any()
    if trash_row is not None and int8:
        assert torch.equal(emu[trash_row], torch.zeros_like(emu[trash_row]))  # scale 0 reads as zeros


def test_emulation_row_with_no_key_writes_zero():
    """Only an all-masked row leaves den = 0: the merge writes 0 there, as
    the kernel does (a split with no live key carries l = 0, m = -1e30)."""
    q, kp, vp, _, table, offsets = _inputs(3, 2, 1, 4, 4, 16, 8, 4, [0, 31])
    tt = [torch.from_numpy(x) for x in (q, kp, vp, table, offsets)]
    # no key is live in any split: a q_offset of -1 with T 1 admits none
    out = split_merge_emulation(tt[0], tt[1], tt[2], tt[3], torch.tensor([-1, -1], dtype=torch.int32),
                                causal=False, alibi=True, kps=4)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_paged_pools_must_be_16_byte_aligned(dtype):
    """K4 copies the pools 16 bytes at a time: a pool view 2 bytes past a
    16-byte boundary is refused, an aligned one taken."""
    n = 3 * 8 * 2 * 64
    buf = torch.zeros(n + 16, dtype=dtype)
    aligned = buf[:n].view(3, 8, 2, 64)
    shifted = buf[2 // buf.element_size():][:n].view(3, 8, 2, 64)
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 2 and shifted.is_contiguous()
    tflash.check_aligned(aligned, aligned)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tflash.check_aligned(aligned, shifted)


def test_paged_launch_checks_alignment_before_the_library(monkeypatch):
    """The launch path refuses a misaligned pool before it builds or loads
    the kernel library, for bf16 and int8 pools."""
    def no_library(name):
        pytest.fail(f"_launch reached _build.library({name!r}) with a misaligned pool")

    monkeypatch.setattr(tpaged._build, "library", no_library)
    n = 3 * 16 * 2 * 64
    q = torch.zeros(1, 1, 4, 64, dtype=torch.bfloat16)
    table = torch.ones(1, 2, dtype=torch.int32)
    for dtype, step in ((torch.bfloat16, 1), (torch.int8, 2)):
        buf = torch.zeros(n + 16, dtype=dtype)
        aligned, shifted = buf[:n].view(3, 16, 2, 64), buf[step:step + n].view(3, 16, 2, 64)
        sc = torch.ones(3, 16, 2, 1) if dtype == torch.int8 else None
        for k, v in ((shifted, aligned), (aligned, shifted)):
            with pytest.raises(ValueError, match="16-byte aligned"):
                tpaged._launch(q, k, v, table, 0, causal=False, alibi=True, scale=None, k_scale=sc, v_scale=sc)


def test_paged_attention_needs_a_block():
    q = torch.zeros(1, 1, 4, 16)
    pool = torch.zeros(3, 8, 4, 16)
    with pytest.raises(ValueError, match="n_blocks >= 1"):
        tpaged.paged_attention(q, pool, pool, torch.zeros(1, 0, dtype=torch.int32), 0, causal=False)
