"""Drive the PyTorch/CUDA port on one H100 and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):

1. print the card's name and power limit; build every CUDA kernel from
   ``zero_transformer_tpu_torch/csrc`` with nvcc (one process per source,
   in parallel) and print the build time;
2. kernels: hold each kernel against its plain PyTorch version at the
   serving path's shapes and on edge cases, in bf16 (atol/rtol 2e-2) and
   float32 (atol 1e-4); hold the bf16 tensor-core flash kernel besides to
   an emulation of its own rounding (one bf16 ulp plus 2^-13 per output,
   at most 0.1 % of outputs different) and show that this check catches a
   causal limit or validity mask one key off; time kernel, plain version
   and a PyTorch library call computing the same function (a yardstick
   only);
3. serving: seed-initialise the ``125m`` zoo model in bf16, start the port's
   engine and HTTP server on 127.0.0.1 (4 slots, cache 1024, page 16,
   chunk 64) and answer concurrent greedy ``POST /generate`` requests; the
   kernel launch counts are zeroed just before and read just after, and
   both kernels must have run;
4. parity: the same model with ``attention_impl="xla"`` (the plain path)
   against the kernels on prefill logits and four decode steps: float32
   within atol 1e-4, bf16 no farther from the float32 plain path than the
   bf16 plain path plus 2e-2; then greedy agreement of a whole engine run;
5. profile: twenty decode ticks of four streams under ``torch.profiler``:
   device busy time per tick against the ticks' wall time;
6. training kernels: the differentiable flash entry (K1 with lse, K2 dq,
   K3 dk/dv) through ``torch.autograd`` against ``flash_reference`` and
   ``flash_bwd_reference`` at the training shape (B 8, T = S = 1024, 12
   heads of 64, bf16), at 580m's one-card shape (B 1, T = S 8192, 12 heads
   of 128, bf16) and on GQA, non-ALiBi, non-causal, ragged-T and D 128
   cases: float32 within atol 1e-4; bf16 K2/K3 within one bf16 ulp plus
   6e-3 of the largest |grad| of the float32 reference on the same o and
   lse, and at both timed shapes the same bar must reject a reference whose
   causal limit is one key off; K2 and K3 twice on the same inputs write the
   same bits; times of kernel, plain version and the backward of
   ``scaled_dot_product_attention`` with the ALiBi float bias (a yardstick);
7. training: ``125m`` at full width and depth, bf16 over float32 master
   params, seed-0 weights: (a) one micro-batch's loss and grads through the
   kernels against the plain path (``attention_impl="xla"``) in bf16 and in
   float32; (b) the launch counts of one optimizer step of B 8 x accum 4 x
   T 1024 (12 x accum each for ``flash_train_fwd``, ``flash_dq``,
   ``flash_dkv``); (c) the loss over 20 steps on one repeated batch at a
   constant learning rate must fall, and two steps run under
   ``torch.profiler`` (device busy share, largest kernels); (d) the trainer CLI on
   ``configs/train_125m.yaml`` with synthetic data takes a few steps and
   reports tokens/s, step ms and the model-FLOPs share of 989 TFLOP/s;
8. packed kernels: K1 (with lse), K2 and K3 with the packed-document mask
   (``doc_ids``) through ``torch.autograd`` against their plain versions at
   ``byte_25m``'s training shape (B 32, T = S 512, 8 heads of 64) in bf16
   and float32, on GQA and D 128 cases, over documents that start at keys
   63, 64 and 65, separators at 0 and T-1, one-token documents, a row with
   no separator and real packed rows of the repo's text; the bars of phase
   6, and the bf16 bars must reject plain versions given inclusive-cumsum
   ids (each separator moved into the next document); times of kernel,
   plain version and SDPA with one float bias of ALiBi + causal + documents;
9. packed: ``byte_25m`` at full width and depth on the repo's own text
   (``*.md``, ``docs/*.md``, ``.py``; held out by document hash): the
   port's ``prepare`` writes tar shards, the kernel path meets the plain
   path on one packed micro-batch (phase 7's bars), the trainer runs
   ``configs/train_e2e_bytes.yaml`` for 300 steps (8 launches of each
   ``_docs`` counter per step, a validation loss below the held-out bytes'
   unigram entropy), the eval harness scores the trained model (bits per
   byte below that entropy and within 0.01 of the plain path's; last-word
   and choice accuracy), and the trainer CLI takes 20 steps on the shards;
   then the trained model with weight-only int8 scores bits per byte within
   log2(1.02) of its bf16 value (JAX's 2 % perplexity budget), and serves
   eight held-out prompts in-process twice, in bf16 and with int8 KV plus
   int8 weights: the share of greedy tokens before the first divergence;
10. int8 kernels: K4 over int8 pools with float32 scales (the TPU kernel's
   int8 branch) against its plain version at the serving shapes (T 1, 3
   and 8; offsets 0 to 1023), GQA, D 128, a trash-page row and a
   NaN-poisoned row, bf16 (atol/rtol 2e-2) and float32 (atol 1e-4); the bf16
   bar must reject plain versions that read the scale of the next position
   or of the next kv head; times of the kernel, the plain version, the bf16
   K4 on the dequantized pools and a library yardstick;
11. int8 serving: the serving phase with ``125m``'s weights quantized to
   int8 and an int8 KV cache (the CLI's ``--quantize int8 --kv-cache-dtype
   int8``): every request done, K4's int8 branch and K1 launched, the bf16
   K4 never; then the parity and profile phases on that engine.

12. sp_kernels: ``flash_partial`` (K1 at global offsets, f32 output) and
   ``flash_grads`` (K2/K3 given the global lse and delta, f32 grads) against
   their plain versions at 580m's ring shape (B 1, a 2048-token shard, 12
   heads of 128) in bf16 and f32, a GQA and a D 64 case: the diagonal, a
   past and a future shard of a 3-shard row, with and without separate
   query and key document ids; the bf16 bars must reject a plain version
   one key off in kv_offset and one that reads the query ids as key ids; a
   future shard writes o = 0, lse = -1e30 and zero grads; K2 and K3 twice
   on a past shard write the same bits; times of kernel, plain version and
   SDPA with the block's float bias (and its backward);
13. sequence_parallel: 580m at T 8192 over 4 ranks (NCCL with a card per
   rank on a 4-card machine, else 4 ranks sharing card 0 over gloo): the
   ring at the layer shape against the one-card ``flash_attention`` on the
   gathered tensors, one ring train step against the one-card step (loss,
   grad cosines, bit-equal params across ranks, exact launch counts, peak
   memory, the transfers' share under ``torch.profiler``), plain and packed,
   then the trainer CLI under ``torch.distributed.run`` for 3 steps of
   ``configs/train_580m_8k.yaml`` and the same CLI on one card; the one-card
   reference step's launches give the D 128 rows of the kernel table.

``--phases sequence_parallel_f32`` (never part of a full run) repeats
phase 13's parity with the model in float32, so that every kernel on both
sides takes its f32 path: the ring's distance to the one-card step without
bf16 rounding.

``--phases a,b,...`` builds the kernels and runs the named phases only
(kernels, serving, parity, profile, int8_kernels, int8_serving,
train_kernels, training, packed_kernels, packed, sp_kernels,
sequence_parallel, and sequence_parallel_f32; parity needs serving); the
kernel table then lists the kernels whose phases ran.

The last two lines of standard output are the kernel table as one JSON
object and ``{"ok": true, "device": {...}}`` (a full run only). Without CUDA the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import functools
import gc
import hashlib
import json
import math
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: dict(atol=2e-2, rtol=2e-2), torch.float32: dict(atol=1e-4, rtol=0.0)}
# the bf16 flash kernel against the emulation of its own rounding. Set from
# readings on an H100 at the kernel phase's cases: 0.01-0.03 % of outputs
# differ at all, by at most one ulp, or by up to 6.1e-5 on outputs near zero
# (five ulps at 5.8e-4); lse within 4.8e-7. A key missing from a ~250-key
# window moves most outputs of its rows by ~4e-3.
MMA_ATOL = 2.0**-13
MMA_DIFFER_SHARE = 1e-3
MMA_LSE_ATOL = 1e-4

# 125m serving shapes (ServingConfig defaults at cache_len 1024)
H, D, PAGE, CACHE, CHUNK, SLOTS = 12, 64, 16, 1024, 64, 4


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 30) -> float:
    """Device time per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a spin kernel (``torch.cuda._sleep``), so that the calls'
    kernels run back to back on the device. ``time_ms``'s events also count
    the host's time between launches, which decides the reading when one
    call's kernels take less than its Python wrapper. The reading counts
    only if the start event was still pending when the host had queued
    every call; otherwise the spin is made longer. (``torch.profiler``
    sessions this short miss launches of the port's kernels: they read
    0.0 ms for a 0.2 ms kernel.)"""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        if cycles >= 1 << 32:
            raise AssertionError("device_ms: the calls were not queued within a ~2 s spin (does fn sync?)")
        cycles *= 4


def compare(got: torch.Tensor, ref: torch.Tensor, dtype, what: str) -> float:
    """Fail unless ``got`` matches ``ref`` (NaN where ref is NaN); returns
    the largest absolute error over finite entries."""
    got, ref = got.float(), ref.float()
    nan_ref = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan_ref):
        raise AssertionError(f"{what}: NaN pattern differs from the plain version")
    ok = ~nan_ref
    err = (got[ok] - ref[ok]).abs()
    tol = TOL[dtype]
    bad = err > tol["atol"] + tol["rtol"] * ref[ok].abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if bool(bad.any()):
        raise AssertionError(f"{what}: max |err| {max_err} beyond {tol}")
    return max_err


# ------------------------------------------------------------------ kernels


def flash_case(B, T, S, KVH, dtype, offsets, valid_lens, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, KVH, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, KVH, D, generator=g, device="cuda").to(dtype)
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    seg = (torch.arange(S, device="cuda")[None, :] < torch.tensor(valid_lens, device="cuda")[:, None]).int()
    return q, k, v, offs, seg


def paged_case(B, T, n_blocks, KVH, dtype, offsets, seed, trash_row=None, nan_row=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = B * n_blocks + 1
    q = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    kp = torch.randn(n_pages, PAGE, KVH, D, generator=g, device="cuda").to(dtype)
    vp = torch.randn(n_pages, PAGE, KVH, D, generator=g, device="cuda").to(dtype)
    # ragged: each row maps the blocks its offset needs, in shuffled order;
    # the rest of its table stays on the trash page 0
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = torch.zeros(B, n_blocks, dtype=torch.int32)
    used = 0
    for b, off in enumerate(offsets):
        need = min(n_blocks, -(-(off + T) // PAGE))
        table[b, :need] = perm[used:used + need]
        used += need
    if trash_row is not None:
        table[trash_row] = 0
    if nan_row is not None:
        q[nan_row] = float("nan")
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    return q, kp, vp, table.to("cuda"), offs


def flash_bound(B, T, offsets, KVH, dtype):
    """Least time for this call: the bytes it must move (q, the K/V keys the
    causal limit admits, the validity mask, out) against HBM, or its flops
    against the dtype's peak, whichever is larger."""
    el = torch.finfo(dtype).bits // 8
    keys = sum(min(o + T, CACHE) for o in offsets)
    nbytes = 2 * B * T * H * D * el + 2 * keys * KVH * D * el + 4 * B * CACHE
    flops = sum(4 * T * min(o + T, CACHE) * D * H for o in offsets)
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def paged_bound(B, T, offsets, KVH, dtype):
    el = torch.finfo(dtype).bits // 8
    keys = sum(min(o + T, CACHE) for o in offsets)
    nbytes = 2 * B * T * H * D * el + 2 * keys * KVH * D * el + 4 * B * (CACHE // PAGE) + 4 * B
    flops = sum(4 * T * min(o + T, CACHE) * D * H for o in offsets)
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significant bits) of |x|."""
    _, e = torch.frexp(x.float().abs().clamp(min=2.0**-30))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)


def flash_mma_emulation(q, k, v, offsets, seg, docs=None, with_flip=False, kv_offsets=0, k_docs=None,
                        round_out=True):
    """The bf16 tensor-core kernel's arithmetic, step by step: scores from
    the bf16 inputs (exact products, summed in float64, then float32), the
    biases in the kernel's order (ALiBi + causal, then the document mask
    when ``docs`` [B, T] is given, then validity), an online softmax over
    its 64-key tiles with m and l in float32 from the unrounded P, P
    rounded to bf16 before the P.V product (exact products summed in
    float64), and the output rounded to bf16 once. A tile past a row's
    causal limit, which the kernel skips, adds exp(-1e10 - m) = 0 here, so
    every tile is visited.
    Returns ``(out [B, T, H, D] bf16, lse [B, H, T] f32)``; with
    ``with_flip`` also ``flip`` [B, T, H, 1]: how far one p rounded to the
    neighbouring bf16 value can move an output of the row, 2^-7 * max over
    keys of (softmax weight * max |v|) (a bf16 ulp is at most 2^-7 of the
    value). The tensor cores' f32 score sums differ from the exact sum in
    the last bit now and then, and where that flips the rounding of a large
    p, the kernel lands that far from this emulation. ``kv_offsets`` (int or
    [B]) puts the keys at global positions and ``k_docs`` [B, S] gives them
    ids of their own (``flash_partial``); ``round_out=False`` keeps the
    output in float32; a row that sees no key (causal, every key after it)
    is 0 with lse -1e30, as the kernel writes it."""
    from zero_transformer_tpu_torch.ops.flash import row_offsets, slopes_on
    from zero_transformer_tpu_torch.ops.positions import NEG_INF

    B, T, Hq, Dq = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = Hq // KVH
    kd = k.double().repeat_interleave(G, dim=2).transpose(1, 2)  # [B, H, S, D]
    vd = v.double().repeat_interleave(G, dim=2).transpose(1, 2)
    s = (q.double().transpose(1, 2) @ kd.transpose(-1, -2)).float()  # [B, H, T, S]
    offs = row_offsets(offsets, B, q.device)
    kv_offs = row_offsets(kv_offsets, B, q.device)
    dist = (offs[:, None, None] + torch.arange(T, device=q.device)[:, None]
            - (kv_offs[:, None, None] + torch.arange(S, device=q.device)))
    bias = 0.0 - slopes_on(Hq, str(q.device), True)[None, :, None, None] * dist.clamp(min=0)[:, None].float()
    bias = bias + torch.where(dist >= 0, 0.0, NEG_INF)[:, None]
    x = s * (1.0 / Dq**0.5) + bias
    if docs is not None:
        k_docs = docs if k_docs is None else k_docs
        x = x + torch.where(docs[:, :, None] == k_docs[:, None, :], 0.0, NEG_INF)[:, None]
    x = x + torch.where(seg != 0, 0.0, NEG_INF)[:, None, None, :]
    m = torch.full((B, Hq, T, 1), -1e30, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(B, Hq, T, Dq, dtype=torch.float64, device=q.device)
    for j in range(0, S, 64):
        xt = x[..., j:j + 64]
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(xt - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        o = (o * alpha.double() + p.bfloat16().double() @ vd[:, :, j:j + 64]).float().double()
        m = m_new
    l_safe = torch.where(l == 0, 1.0, l)
    out = o.float() / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    dead = (dist.amax(-1) < 0)[:, None, :]  # [B, 1, T]: the row sees no key
    out = torch.where(dead[..., None], 0.0, out)
    lse = torch.where(dead, -1e30, lse)
    out = (out.bfloat16() if round_out else out).transpose(1, 2)
    if not with_flip:
        return out, lse
    vmax = v.float().abs().amax(-1).repeat_interleave(G, dim=2).transpose(1, 2)[:, :, None, :]  # [B, H, 1, S]
    flip = 2.0**-7 * (torch.softmax(x, dim=-1) * vmax).amax(-1, keepdim=True)  # [B, H, T, 1]
    return out, lse, flip.transpose(1, 2)


def mma_miss(got: torch.Tensor, emu: torch.Tensor, flip=0.0):
    """How far ``got`` is from the emulation: the largest |got - emu| over
    its bar (one bf16 ulp of emu plus MMA_ATOL, plus ``flip`` where given)
    and the share of outputs that differ at all."""
    err = (got.float() - emu.float()).abs()
    over = float((err / (bf16_ulp(emu) + MMA_ATOL + flip)).max())
    return over, float((err > 0).float().mean())


def check_mma(got, lse, q, k, v, offs, seg, label, shifted, docs=None, doc_control=None, flip=False):
    """Hold the bf16 tensor-core kernel to its own rounding against
    ``flash_mma_emulation``: every output within one bf16 ulp plus MMA_ATOL,
    at most MMA_DIFFER_SHARE of the outputs different at all, lse within
    MMA_LSE_ATOL. With ``shifted``, also show that the check catches a kernel
    whose causal limit or validity mask is one key off: the emulation with
    every offset one later (one more key visible per row) and with every
    row's last valid key masked must each fail those bars. With
    ``doc_control`` (other document ids), the emulation under those ids
    must fail them too. With ``flip``, every bar also allows one rounding
    flip of a p (``flash_mma_emulation``'s ``flip``): at byte_25m's training
    shape (8.4M outputs) the bar without it misses by up to 9x, with and
    without document ids alike; the reading without the allowance is
    reported as ``over_without_flip``."""
    if flip:
        emu, emu_lse, allowance = flash_mma_emulation(q, k, v, offs, seg, docs, with_flip=True)
    else:
        (emu, emu_lse), allowance = flash_mma_emulation(q, k, v, offs, seg, docs), 0.0
    over, share = mma_miss(got, emu, allowance)
    lse_err = float((lse - emu_lse).abs().max())
    if not (over <= 1.0 and share <= MMA_DIFFER_SHARE and lse_err <= MMA_LSE_ATOL):
        miss = (got.float() - emu.float()).abs() / (bf16_ulp(emu) + MMA_ATOL + allowance)
        worst = tuple(int(i) for i in torch.unravel_index(miss.argmax(), miss.shape))
        raise AssertionError(f"flash {label} vs the mma emulation: max err {over} of its bar at "
                             f"[b, t, h, d] = {list(worst)} (kernel {float(got[worst])}, emulation "
                             f"{float(emu[worst])}), {share} of outputs differ (bar {MMA_DIFFER_SHARE}), "
                             f"lse {lse_err} (bar {MMA_LSE_ATOL})")
    out = {"max_err_over_bar": over, "differ_share": share, "lse_max_abs_err": lse_err}
    if flip:
        out["over_without_flip"] = mma_miss(got, emu)[0]
    controls = {}
    if shifted:
        last = seg.int().cumsum(1) == seg.int().sum(1, keepdim=True)
        fewer = seg.bool() & ~(last & seg.bool())  # each row's last valid key masked
        controls = {"causal_limit_plus_1": (offs + 1, seg, docs), "validity_minus_1": (offs, fewer.int(), docs)}
    if doc_control is not None:
        controls["inclusive_doc_ids"] = (offs, seg, doc_control)
    for what, (o2, s2, d2) in controls.items():
        s_over, s_share = mma_miss(got, flash_mma_emulation(q, k, v, o2, s2, d2)[0], allowance)
        if s_over <= 1.0 and s_share <= MMA_DIFFER_SHARE:
            raise AssertionError(f"flash {label}: the {what} emulation passes the bars "
                                 f"({s_over}, {s_share}); the check cannot tell them apart")
        out[what] = {"max_err_over_bar": s_over, "differ_share": s_share}
    return out


def sdpa_bias(B, T, S, offsets, seg, dtype):
    from zero_transformer_tpu_torch.ops.positions import NEG_INF, alibi_slopes

    q_pos = torch.tensor(offsets, device="cuda")[:, None] + torch.arange(T, device="cuda")
    dist = q_pos[:, :, None] - torch.arange(S, device="cuda")
    bias = -alibi_slopes(H, "cuda")[None, :, None, None] * dist.clamp(min=0)[:, None].float()
    bias = bias + torch.where(dist >= 0, 0.0, NEG_INF)[:, None]
    bias = bias + torch.where(seg != 0, 0.0, NEG_INF)[:, None, None, :]
    return bias.to(dtype)


def kernel_phase():
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.ops import flash, paged_attention as pa

    rows = {}
    # ---- K1: flash_serving forward, chunked prefill windows
    main_offsets = [0, 256, 512, 896]
    cases = [
        ("main", 4, CHUNK, CACHE, H, torch.bfloat16, main_offsets, [o + CHUNK for o in main_offsets]),
        ("f32", 4, CHUNK, CACHE, H, torch.float32, main_offsets, [o + CHUNK for o in main_offsets]),
        ("edges", 3, CHUNK, CACHE, H, torch.bfloat16, [0, 64, 960], [5, 100, 1000]),
        ("gqa_ragged_T", 2, 40, 256, 4, torch.bfloat16, [16, 200], [56, 240]),
    ]
    for label, B, T, S, KVH, dtype, offs_l, lens in cases:
        q, k, v, offs, seg = flash_case(B, T, S, KVH, dtype, offs_l, lens, seed=len(label))
        got, lse = flash.flash_serving(q, k, v, causal=True, alibi=True, q_offset=offs,
                                       segment_ids=seg, return_lse=True)
        ref, ref_lse = flash.flash_reference(q, k, v, causal=True, alibi=True, q_offset=offs,
                                             segment_ids=seg)
        torch.cuda.synchronize()
        err = compare(got, ref, dtype, f"flash {label}")
        compare(lse, ref_lse, torch.float32 if dtype == torch.float32 else dtype, f"flash lse {label}")
        line = {"kernel": "flash_serving_fwd", "case": label, "dtype": str(dtype), "max_err": err}
        if dtype == torch.bfloat16:
            line["mma"] = check_mma(got, lse, q, k, v, offs, seg, label, shifted=label == "main")
        log(line)
        if label == "main":
            kern = time_ms(lambda: flash.flash_serving(q, k, v, causal=True, alibi=True,
                                                       q_offset=offs, segment_ids=seg))
            plain = time_ms(lambda: flash.flash_reference(q, k, v, causal=True, alibi=True,
                                                          q_offset=offs, segment_ids=seg))
            bias = sdpa_bias(B, T, S, offs_l, seg, dtype)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias))
            bound, by = flash_bound(B, T, offs_l, KVH, dtype)
            dev = device_ms(lambda: flash.flash_serving(q, k, v, causal=True, alibi=True,
                                                        q_offset=offs, segment_ids=seg))
            rows["flash_serving_fwd"] = dict(max_abs_err=err, ms=kern, device_ms=dev, plain_ms=plain,
                                             library_ms=lib, bound_ms=bound, bound_by=by)
            log({"kernel": "flash_serving_fwd", **rows["flash_serving_fwd"]})

    # ---- K4: paged decode
    n_blocks = CACHE // PAGE
    main_offsets = [5, 300, 700, 1000]
    cases = [
        ("main", 4, 1, H, torch.bfloat16, main_offsets, None, None),
        ("f32", 4, 1, H, torch.float32, main_offsets, None, None),
        ("edges", 4, 1, H, torch.bfloat16, [0, 15, 16, 1023], None, None),
        ("trash_nan", 4, 1, H, torch.bfloat16, [0, 63, 64, 500], 0, 2),
        ("verify_gqa", 3, 5, 4, torch.bfloat16, [10, 127, 600], None, None),
        ("verify_f32", 2, 8, H, torch.float32, [0, 1000], None, None),
    ]
    for label, B, T, KVH, dtype, offs_l, trash_row, nan_row in cases:
        q, kp, vp, table, offs = paged_case(B, T, n_blocks, KVH, dtype, offs_l, seed=len(label) + 7,
                                            trash_row=trash_row, nan_row=nan_row)
        causal = T > 1
        got = pa.paged_attention(q, kp, vp, table, offs, causal=causal, alibi=True)
        ref = pa.paged_reference(q, kp, vp, table, offs, causal=causal, alibi=True)
        torch.cuda.synchronize()
        err = compare(got, ref, dtype, f"paged {label}")
        if nan_row is not None and not bool(torch.isnan(got[nan_row]).all()):
            raise AssertionError("paged: a NaN-poisoned q row did not come out NaN")
        log({"kernel": "paged_attention", "case": label, "dtype": str(dtype), "max_err": err})
        if label == "main":
            kern = time_ms(lambda: pa.paged_attention(q, kp, vp, table, offs, causal=False, alibi=True))
            plain = time_ms(lambda: pa.paged_reference(q, kp, vp, table, offs, causal=False, alibi=True))
            valid = (torch.arange(CACHE, device="cuda")[None, :] < offs[:, None] + T).int()
            bias = sdpa_bias(B, T, CACHE, offs_l, valid, dtype)

            def library():
                kk = pa.gather_pages(kp, table).transpose(1, 2)
                vv = pa.gather_pages(vp, table).transpose(1, 2)
                return F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv, attn_mask=bias)

            lib = time_ms(library)
            bound, by = paged_bound(B, T, offs_l, KVH, dtype)
            dev = device_ms(lambda: pa.paged_attention(q, kp, vp, table, offs, causal=False, alibi=True))
            rows["paged_attention"] = dict(max_abs_err=err, ms=kern, device_ms=dev, plain_ms=plain,
                                           library_ms=lib, bound_ms=bound, bound_by=by)
            log({"kernel": "paged_attention", **rows["paged_attention"]})
    return rows


# ------------------------------------------------------------- int8 kernels


def within(got: torch.Tensor, ref: torch.Tensor, dtype) -> bool:
    """Whether ``compare`` would pass: the same NaN pattern and every
    finite entry within the dtype's bar."""
    try:
        compare(got, ref, dtype, "control")
    except AssertionError:
        return False
    return True


def int8_paged_case(B, T, Hq, KVH, Dh, dtype, offsets, seed, trash_row=None, nan_row=None):
    """q and int8 K/V pools quantized by the model's ``_quantize_kv`` from
    random K/V whose magnitude varies by up to e^2 either way between
    (position, kv head) rows, every 7th position all zero; the trash page 0
    keeps zero values and zero scales, as ``allocate_pools`` leaves it."""
    from zero_transformer_tpu_torch.models.gpt import _quantize_kv

    g = torch.Generator(device="cuda").manual_seed(seed)
    n_blocks = CACHE // PAGE
    n_pages = B * n_blocks + 1
    q = torch.randn(B, T, Hq, Dh, generator=g, device="cuda").to(dtype)
    pools = []
    for _ in range(2):
        x = torch.randn(n_pages, PAGE, KVH, Dh, generator=g, device="cuda")
        x = x * torch.exp(torch.rand(n_pages, PAGE, KVH, 1, generator=g, device="cuda") * 4 - 2)
        x[:, ::7] = 0.0
        xq, xs = _quantize_kv(x)
        xq[0], xs[0] = 0, 0.0
        pools += [xq, xs]
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = torch.zeros(B, n_blocks, dtype=torch.int32)
    used = 0
    for b, off in enumerate(offsets):
        need = min(n_blocks, -(-(off + T) // PAGE))
        table[b, :need] = perm[used:used + need]
        used += need
    if trash_row is not None:
        table[trash_row] = 0
    if nan_row is not None:
        q[nan_row] = float("nan")
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    kq, ks, vq, vs = pools
    return q, kq, vq, ks, vs, table.to("cuda"), offs


def int8_paged_bound(B, T, offsets, Hq, KVH, Dh, dtype):
    """Least time for K4 over int8 pools: q read and the output written in
    ``dtype``, each visible key's int8 K and V rows and float32 scales, the
    table and offsets read once, against HBM; or the flops against the
    dtype's peak, whichever is larger."""
    el = torch.finfo(dtype).bits // 8
    keys = sum(min(o + T, CACHE) for o in offsets)
    nbytes = 2 * B * T * Hq * Dh * el + 2 * keys * KVH * (Dh + 4) + 4 * B * (CACHE // PAGE) + 4 * B
    flops = sum(4 * T * min(o + T, CACHE) * Dh * Hq for o in offsets)
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def shift_scales(sc: torch.Tensor, what: str) -> torch.Tensor:
    """A scale pool as a kernel that reads the wrong scale would see it:
    each position the scale of the next position in the pool, or each kv
    head the scale of the next kv head."""
    if what == "next_position":
        return sc.reshape(-1, sc.shape[2], 1).roll(-1, 0).reshape(sc.shape)
    return sc.roll(-1, 2)


# (label, B, T, Hq, KVH, D, dtype, offsets, trash_row, nan_row); "main" is
# the 125m serving decode shape of the kernel phase's K4 "main"
INT8_CASES = [
    ("main", 4, 1, H, H, D, torch.bfloat16, [5, 300, 700, 1000], None, None),
    ("f32", 4, 1, H, H, D, torch.float32, [5, 300, 700, 1000], None, None),
    ("edges", 4, 1, H, H, D, torch.bfloat16, [0, 63, 64, 65], None, None),
    ("edges_f32", 4, 1, H, H, D, torch.float32, [300, 1023, 64, 0], None, None),
    ("verify_T3", 4, 3, H, H, D, torch.bfloat16, [0, 63, 300, 1020], None, None),
    ("verify_T3_f32", 4, 3, H, H, D, torch.float32, [64, 65, 1000, 7], None, None),
    ("verify_T8", 2, 8, H, H, D, torch.bfloat16, [64, 1016], None, None),
    ("verify_T8_f32", 2, 8, H, H, D, torch.float32, [65, 1000], None, None),
    ("gqa", 4, 1, H, 4, D, torch.bfloat16, [63, 300, 700, 1023], None, None),
    ("gqa_T3_f32", 3, 3, H, 4, D, torch.float32, [10, 127, 600], None, None),
    ("d128", 3, 1, 8, 8, 128, torch.bfloat16, [0, 65, 1023], None, None),
    ("d128_gqa_f32", 3, 3, 8, 2, 128, torch.float32, [64, 300, 1000], None, None),
    ("trash_nan", 4, 1, H, H, D, torch.bfloat16, [0, 63, 64, 500], 0, 2),
    ("trash_nan_f32", 4, 1, H, H, D, torch.float32, [300, 63, 64, 1023], 1, 3),
]


def int8_kernel_phase():
    """K4's int8 branch against its plain version (gather the pages and
    scales, dequantize, the reference attention)."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.models.gpt import _quantize_kv
    from zero_transformer_tpu_torch.ops import paged_attention as pa

    # the model's quantizer on the card rounds as on the CPU, where the
    # tests pin it bit for bit to JAX's _quantize_kv
    g = torch.Generator(device="cuda").manual_seed(399)
    x = torch.randn(257, PAGE, H, D, generator=g, device="cuda")
    x = x * torch.exp(torch.rand(257, PAGE, H, 1, generator=g, device="cuda") * 8 - 4)
    (cq, cs), (hq, hs) = _quantize_kv(x), _quantize_kv(x.cpu())
    if not (torch.equal(cq.cpu(), hq) and torch.equal(cs.cpu().view(torch.int32), hs.view(torch.int32))):
        raise AssertionError("_quantize_kv on the card differs from the CPU's bits")
    log({"quantize_kv_card_equals_cpu": {"rows": x.numel() // D, "equal": True}})

    rows = {}
    for label, B, T, Hq, KVH, Dh, dtype, offs_l, trash_row, nan_row in INT8_CASES:
        q, kq, vq, ks, vs, table, offs = int8_paged_case(B, T, Hq, KVH, Dh, dtype, offs_l, len(label) + 400,
                                                         trash_row, nan_row)
        kw = dict(causal=T > 1, alibi=True)
        got = pa.paged_attention(q, kq, vq, table, offs, k_scale=ks, v_scale=vs, **kw)
        ref = pa.paged_reference(q, kq, vq, table, offs, k_scale=ks, v_scale=vs, **kw)
        torch.cuda.synchronize()
        err = compare(got, ref, dtype, f"paged int8 {label}")
        if nan_row is not None and not bool(torch.isnan(got[nan_row]).all()):
            raise AssertionError(f"paged int8 {label}: a NaN-poisoned q row did not come out NaN")
        if trash_row is not None and not bool((got[trash_row] == 0).all()):
            raise AssertionError(f"paged int8 {label}: a row on the zero-scale trash page is not all zero")
        line = {"kernel": "paged_attention_int8", "case": label, "dtype": str(dtype),
                "shape": [B, T, Hq, KVH, Dh], "max_err": err}
        if label in ("main", "gqa", "verify_T3"):
            # the bar must see the scale walk: a plain version that reads the
            # scale of the next position, or of the next kv head, fails it
            for what in ("next_position", "next_kv_head"):
                bad = pa.paged_reference(q, kq, vq, table, offs, k_scale=shift_scales(ks, what),
                                         v_scale=shift_scales(vs, what), **kw)
                if within(got, bad, dtype):
                    raise AssertionError(f"paged int8 {label}: the {what} scale control passes the bar")
                line[f"{what}_control_max_err"] = float((got.float() - bad.float()).nan_to_num().abs().max())
        log(line)
        if label != "main":
            continue
        kern = time_ms(lambda: pa.paged_attention(q, kq, vq, table, offs, k_scale=ks, v_scale=vs, **kw))
        kern_dev = device_ms(lambda: pa.paged_attention(q, kq, vq, table, offs, k_scale=ks, v_scale=vs, **kw))
        plain = time_ms(lambda: pa.paged_reference(q, kq, vq, table, offs, k_scale=ks, v_scale=vs, **kw))
        kd, vd = pa.dequantize(kq, ks, dtype), pa.dequantize(vq, vs, dtype)
        bf16_k4 = time_ms(lambda: pa.paged_attention(q, kd, vd, table, offs, **kw))
        bf16_k4_dev = device_ms(lambda: pa.paged_attention(q, kd, vd, table, offs, **kw))
        valid = (torch.arange(CACHE, device="cuda")[None, :] < offs[:, None] + T).int()
        bias = sdpa_bias(B, T, CACHE, offs_l, valid, dtype)

        def library():
            kk = pa.dequantize(pa.gather_pages(kq, table), pa.gather_pages(ks, table), dtype).transpose(1, 2)
            vv = pa.dequantize(pa.gather_pages(vq, table), pa.gather_pages(vs, table), dtype).transpose(1, 2)
            return F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv, attn_mask=bias)

        lib = time_ms(library)
        bound, by = int8_paged_bound(B, T, offs_l, Hq, KVH, Dh, dtype)
        rows["paged_attention_int8"] = dict(max_abs_err=err, ms=kern, device_ms=kern_dev, plain_ms=plain,
                                            library_ms=lib, bound_ms=bound, bound_by=by)
        log({"kernel": "paged_attention_int8", "shape": [B, T, Hq, KVH, Dh], "offsets": offs_l,
             "bf16_k4_on_dequantized_pools_ms": bf16_k4,
             "bf16_k4_on_dequantized_pools_device_ms": bf16_k4_dev, **rows["paged_attention_int8"]})
    return rows


# ------------------------------------------------------------------ serving

PROMPT_LENS = (5, 63, 64, 65, 300, 900)
MAX_NEW = 32
SEED = 0


def prompt_text(n: int, salt: int) -> str:
    """``n`` printable non-space bytes (one byte-tokenizer token each)."""
    alphabet = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    return "".join(alphabet[(7 * i + 3 * salt + i // 11) % len(alphabet)] for i in range(n))


# the CLI's --kv-cache-dtype int8 --quantize int8
INT8 = dict(kv="int8", weights="int8")


def build_engine(impl: str, dtype=torch.bfloat16, kv: str = "auto", weights: str = "none", name: str = "125m",
                 state=None, cache_len: int = CACHE):
    """The serving engine over ``name`` with seed-``SEED`` weights (or
    ``state``), its KV cache in ``kv`` ("auto" or "int8"); ``weights="int8"``
    quantizes the weights with ``quant.quantize_model``, the host route of the
    CLI's ``--quantize int8``."""
    from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
    from zero_transformer_tpu_torch.models import model_getter
    from zero_transformer_tpu_torch.models.quant import quantize_model
    from zero_transformer_tpu_torch.serving import ServingEngine

    model = model_getter(name, dtype=dtype, device="cuda", seed=SEED if state is None else None,
                         attention_impl=impl, kv_cache_dtype=kv)
    if state is not None:
        model.load_state_dict(state)
    if weights == "int8":
        model = quantize_model(model)
    return ServingEngine(model, n_slots=SLOTS, cache_len=cache_len, sampling=SamplingConfig(greedy=True),
                         prefill_chunk=CHUNK, page_size=PAGE, device="cuda")


def http(method: str, url: str, body=None, timeout: float = 300.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def serving_phase(int8: bool = False):
    """125m behind the port's HTTP server; concurrent greedy requests. With
    ``int8``: int8 weights and KV cache, served through K4's int8 branch."""
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.serve import ByteTokenizer
    from zero_transformer_tpu_torch.serving import ServingServer

    label = "int8_serving" if int8 else "serving"
    engine = build_engine("auto", **(INT8 if int8 else {}))
    # warm-up (cuBLAS handles, the allocator, both kernels) through the
    # trash page only: an all-zero table at position 0 touches no slot
    with torch.no_grad():
        zeros = torch.zeros(SLOTS, CACHE // PAGE, dtype=torch.int32, device="cuda")
        at0 = torch.zeros(SLOTS, dtype=torch.int32, device="cuda")
        for T in (CHUNK, 1):
            engine.model.forward_paged(torch.zeros(SLOTS, T, dtype=torch.long, device="cuda"),
                                       engine.pools, zeros, at0)
    torch.cuda.synchronize()
    server = ServingServer(engine, ByteTokenizer(), host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        for _ in range(600):
            try:
                if http("GET", base + "/healthz", timeout=10)[0] == 200:
                    break
            except urllib.error.HTTPError:
                time.sleep(0.05)
        results = [None] * len(PROMPT_LENS)

        def client(i, n):
            body = {"prompt": prompt_text(n, i), "max_new_tokens": MAX_NEW, "seed": i,
                    "stream": i % 2 == 1}
            code, text = http("POST", base + "/generate", body)
            if body["stream"]:
                events = [json.loads(x[6:]) for x in text.splitlines() if x.startswith("data: ")]
                toks = [e["token"] for e in events if "token" in e]
                results[i] = (code, events[-1]["status"], toks)
            else:
                doc = json.loads(text)
                results[i] = (code, doc["status"], doc["tokens"])

        _build.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i, n)) for i, n in enumerate(PROMPT_LENS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        _, text = http("GET", base + "/metrics")
        metrics = json.loads(text)
    finally:
        server.stop()
    for i, n in enumerate(PROMPT_LENS):
        if results[i] is None:
            raise AssertionError(f"request with a {n}-token prompt got no answer")
        code, status, toks = results[i]
        if code != 200 or status != "done" or len(toks) != MAX_NEW:
            raise AssertionError(f"{n}-token prompt: HTTP {code}, {status}, {len(toks)} tokens")
    if metrics["poisoned_slots"]:
        raise AssertionError(f"{metrics['poisoned_slots']} slots saw non-finite logits")
    paged = "paged_attention_int8" if int8 else "paged_attention"
    if not all(launches[k] > 0 for k in ("flash_serving_fwd", paged)):
        raise AssertionError(f"a kernel of the {label} path never launched: {launches}")
    if int8 and launches["paged_attention"]:
        raise AssertionError(f"the int8 path launched the bf16 paged kernel: {launches}")
    summary = {
        "requests": len(PROMPT_LENS), "prompt_lens": PROMPT_LENS, "max_new_tokens": MAX_NEW,
        "wall_s": wall, "tokens_out": metrics["tokens_out"],
        "ttft_ms_p50": metrics["ttft_ms_p50"], "ttft_ms_p99": metrics["ttft_ms_p99"],
        "itl_ms_p50": metrics["itl_ms_p50"], "itl_ms_p99": metrics["itl_ms_p99"],
        "decode_tok_s": metrics["decode_tok_s"], "decode_ticks": metrics["decode_ticks"],
        "prefill_ticks": metrics["prefill_ticks"],
        "kv_cache_dtype": metrics["kv_cache_dtype"], "kv_pool_bytes": metrics["kv_pool_bytes"],
        "param_quant": metrics["param_quant"], "weight_bytes": metrics["weight_bytes"],
        "paged_launches_per_decode_tick": launches[paged] / metrics["decode_ticks"],
        "flash_launches_per_prefill_tick": launches["flash_serving_fwd"] / metrics["prefill_ticks"],
        "launches": launches,
    }
    log({label: summary})
    return launches, [r[2] for r in results], summary


def kernel_times(prof) -> dict:
    """{kernel name: (device ms, launches)} from a ``torch.profiler`` run.
    Kernel events only: CPU ops also carry the device time of what they
    launched, and counting both would double it; user annotations
    (``record_function`` spans, which the profiler also lays on the device
    timeline) are not kernels either."""
    kernels = {}
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA") and not getattr(ev, "is_user_annotation", False):
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            kernels[ev.key] = (dev_us / 1e3, ev.count)
    return kernels


def top_kernels(kernels: dict, n: int, per: int, width: int) -> dict:
    """The ``n`` largest kernels by device time, in ms per tick or step
    (``per`` of them), under their names cut to ``width`` characters;
    kernels whose cut names coincide are summed."""
    out = {}
    for k, (ms, _) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:n]:
        out[k[:width]] = out.get(k[:width], 0.0) + ms / per
    return out


def profile_phase(ticks: int = 20, int8: bool = False):
    """Where a decode tick's time goes: four 300-token streams prefilled,
    then ``ticks`` decode ticks under ``torch.profiler``. Device busy time is
    the sum of the CUDA kernels' self time; its share of the ticks' wall time
    says how far the host holds the card back. (The host clock around the
    profiled ticks includes the profiler's own overhead; the untraced tick
    time is the serving phase's ITL.) ``int8``: int8 weights and KV cache."""
    from torch.profiler import ProfilerActivity, profile

    engine = build_engine("auto", **(INT8 if int8 else {}))
    for i in range(SLOTS):
        engine.submit(list(prompt_text(300, 70 + i).encode()), max_new_tokens=ticks + 10, seed=i)
    while engine.active_count < SLOTS:
        engine.step()
    engine.step()  # one tick with every slot decoding, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_times(prof)
    busy_ms = sum(ms for ms, _ in kernels.values())
    log({"int8_profile" if int8 else "profile": {
        "decode_ticks": ticks, "slots": SLOTS, "wall_ms_per_tick": wall_ms / ticks,
        "device_busy_ms_per_tick": busy_ms / ticks if kernels else "not measured",
        "device_busy_share": busy_ms / wall_ms if kernels else "not measured",
        "device_launches_per_tick": sum(c for _, c in kernels.values()) / ticks,
        "top_kernels_ms_per_tick": top_kernels(kernels, 8, ticks, 60),
    }})


def forced_logits(engine, prompts, table, forced=None, steps: int = 4):
    """Prefill ``prompts`` chunk by chunk through ``forward_paged``, then
    decode ``steps`` tokens: the given ``forced`` tokens, or greedy. Returns
    the logits [B, V] (float32) of the prefill's last position and of each
    decode step, and the tokens fed."""
    from zero_transformer_tpu_torch.inference.generate import allocate_pools

    B = len(prompts)
    lens = [len(p) for p in prompts]
    pools = allocate_pools(engine.cfg, table.shape[0] * table.shape[1] + 1, PAGE, "cuda")
    model = engine.model
    fill, last = [0] * B, [None] * B
    with torch.no_grad():
        while any(f < n for f, n in zip(fill, lens)):
            rows = [b for b in range(B) if fill[b] < lens[b]]
            toks = [prompts[b][fill[b]:fill[b] + CHUNK] for b in rows]
            toks = [t + [0] * (CHUNK - len(t)) for t in toks]
            offs = torch.tensor([fill[b] for b in rows], dtype=torch.int32, device="cuda")
            h = model.forward_paged(torch.tensor(toks, device="cuda"), pools, table[rows], offs)
            for r, b in enumerate(rows):
                if fill[b] + CHUNK >= lens[b]:
                    last[b] = model.logits(h[r, lens[b] - 1 - fill[b]]).float()
                fill[b] = min(fill[b] + CHUNK, lens[b])
        out, fed = [torch.stack(last)], []
        for step in range(steps):
            tok = out[-1].argmax(-1) if forced is None else forced[step]
            fed.append(tok)
            offs = torch.tensor([n + step for n in lens], dtype=torch.int32, device="cuda")
            out.append(model.logits(model.forward_paged(tok[:, None], pools, table, offs)[:, 0]).float())
    return out, fed


def checked_reads(engine, prompts, table, forced):
    """``forced_logits`` on the kernel path over the int8 cache, with every
    layer's attention call held against the plain path's read of the same
    pools: the call runs again with ``attention_impl="xla"`` on the same
    input over a copy of the pools as they were before it. Both paths write
    the same int8 values and scales (checked bit for bit), so only the
    reads differ: the attention output (the out projection's input) must
    agree within float32 atol 1e-4. Control: the plain read of pools whose
    scales are each the next position's must miss that bar in every decode
    call. Returns the logits and the readings."""
    import copy
    import dataclasses

    from zero_transformer_tpu_torch.models.gpt import KVPools
    from zero_transformer_tpu_torch.ops.paged_attention import MAX_DECODE_T

    blocks = engine.model.blocks
    seen = []
    err = {"prefill": 0.0, "decode": 0.0}
    control = []
    hooks = [blk.attn.out.register_forward_pre_hook(lambda _m, args: seen.append(args[0].float()))
             for blk in blocks]
    fwd = type(blocks[0].attn).forward_paged

    def checked(x, pools, block_table, offsets, attn, plain):
        before = KVPools(*(t.clone() for t in (pools.k, pools.v, pools.k_scale, pools.v_scale)))
        out = fwd(attn, x, pools, block_table, offsets)
        got = seen.pop()
        shifted = dataclasses.replace(before, k=before.k.clone(), v=before.v.clone(),
                                      k_scale=shift_scales(before.k_scale, "next_position"),
                                      v_scale=shift_scales(before.v_scale, "next_position"))
        fwd(plain, x, before, block_table, offsets)
        want = seen.pop()
        if not all(torch.equal(a, b) for a, b in ((pools.k, before.k), (pools.v, before.v),
                                                  (pools.k_scale, before.k_scale),
                                                  (pools.v_scale, before.v_scale))):
            raise AssertionError("the kernel and plain paths wrote different int8 pools")
        kind = "prefill" if x.shape[1] > MAX_DECODE_T else "decode"
        err[kind] = max(err[kind], compare(got, want, torch.float32, f"int8-cache {kind} read"))
        if kind == "decode":
            fwd(plain, x, shifted, block_table, offsets)
            miss = float((got - seen.pop()).abs().max())
            if not miss > TOL[torch.float32]["atol"]:
                raise AssertionError(f"the next-position scale control reads {miss}: within the bar")
            control.append(miss)
        return out

    for blk in blocks:
        plain = copy.copy(blk.attn)
        plain.cfg = dataclasses.replace(blk.attn.cfg, attention_impl="xla")
        blk.attn.forward_paged = functools.partial(checked, attn=blk.attn, plain=plain)
    try:
        logits, _ = forced_logits(engine, prompts, table, forced)
    finally:
        for blk in blocks:
            del blk.attn.forward_paged
        for h in hooks:
            h.remove()
    return logits, {"read_max_abs_err": err, "decode_reads": len(control),
                    "next_position_scale_control_min": min(control)}


def parity_phase(kernel_tokens, int8: bool = False):
    """The kernels against the plain path (``attention_impl="xla"``): logits
    of a prefill (last position) and four decode steps at the serving
    shapes, every run fed the same tokens, then greedy token agreement of a
    whole plain-path engine run with the serving phase. ``int8``: int8
    weights and an int8 KV cache on both paths.

    float32 with ``int8``: the cache rounds each K/V element to a step of
    max|row| / 127, so a last-bit difference in a layer's input moves an
    element that sits near a rounding edge by a whole step, and the logits
    by ~1e-3 after 12 layers, whichever path computed the difference: two
    paths that each write their own cache drift apart without either being
    wrong. So the 1e-4 bar holds on the logits of int8 weights over a
    float32 cache, where nothing rounds to int8 at run time, and on every
    attention read over the int8 cache where both paths read the same pools
    (``checked_reads``); the whole-model logits over two int8 caches are
    reported without a bar.

    float32: kernel path vs plain path within atol 1e-4 (fatal). bfloat16:
    every layer rounds the residual stream to bf16, so after 12 layers both
    bf16 paths sit a few bf16 ulps of the logits away from the float32
    plain path; the bar (fatal) is that the kernel path is no farther from
    it than the bf16 plain path plus the bf16 tolerance 2e-2."""
    lens = (65, 300, 900)
    n_blocks = CACHE // PAGE
    table = torch.stack([
        torch.arange(1 + b * n_blocks, 1 + (b + 1) * n_blocks, dtype=torch.int32) for b in range(len(lens))
    ]).to("cuda")
    prompts = [[ord(c) for c in prompt_text(n, 50 + b)] for b, n in enumerate(lens)]
    quant = INT8 if int8 else {}
    ref, forced = forced_logits(build_engine("xla", torch.float32, **quant), prompts, table)
    int8_cache = {}
    if int8:
        f32_k, int8_cache = checked_reads(build_engine("auto", torch.float32, **quant), prompts, table, forced)
        w_x, _ = forced_logits(build_engine("xla", torch.float32, weights="int8"), prompts, table, forced)
        w_k, _ = forced_logits(build_engine("auto", torch.float32, weights="int8"), prompts, table, forced)
        f32_err = max(compare(k, r, torch.float32, f"float32 logits, int8 weights, step {i}")
                      for i, (k, r) in enumerate(zip(w_k, w_x)))
        kernel = [float((k - r).abs().max()) for k, r in zip(f32_k, ref)]
        if not all(math.isfinite(e) for e in kernel):
            raise AssertionError(f"float32 logits over the int8 cache are not finite: {kernel}")
        int8_cache["whole_model_kernel_vs_plain_per_step"] = kernel
    else:
        f32_k, _ = forced_logits(build_engine("auto", torch.float32), prompts, table, forced)
        f32_err = max(compare(k, r, torch.float32, f"float32 logits, step {i}")
                      for i, (k, r) in enumerate(zip(f32_k, ref)))
    bf_x, _ = forced_logits(build_engine("xla", **quant), prompts, table, forced)
    bf_k, _ = forced_logits(build_engine("auto", **quant), prompts, table, forced)
    worst = {"kernel_vs_f32": 0.0, "plain_vs_f32": 0.0, "kernel_vs_plain": 0.0}
    agree, steps = 0, []
    for i, (k, x, r) in enumerate(zip(bf_k, bf_x, ref)):
        e_k, e_x = float((k - r).abs().max()), float((x - r).abs().max())
        steps.append([e_k, e_x])
        if not (math.isfinite(e_k) and e_k <= e_x + TOL[torch.bfloat16]["atol"]):
            raise AssertionError(f"bf16 logits step {i}: kernel path {e_k} from float32 vs plain {e_x}")
        worst["kernel_vs_f32"] = max(worst["kernel_vs_f32"], e_k)
        worst["plain_vs_f32"] = max(worst["plain_vs_f32"], e_x)
        worst["kernel_vs_plain"] = max(worst["kernel_vs_plain"], float((k - x).abs().max()))
        agree += int((k.argmax(-1) == x.argmax(-1)).sum())
    # a whole plain-path engine run on the serving phase's requests
    eng_x = build_engine("xla", **quant)
    handles = [eng_x.submit(list(prompt_text(n, i).encode()), max_new_tokens=MAX_NEW, seed=i)
               for i, n in enumerate(PROMPT_LENS)]
    eng_x.run_until_idle()
    same = sum(int(a == b) for h, ref_toks in zip(handles, kernel_tokens) for a, b in zip(h.tokens, ref_toks))
    prefix = [next((j for j, (a, b) in enumerate(zip(h.tokens, ref_toks)) if a != b), len(ref_toks))
              for h, ref_toks in zip(handles, kernel_tokens)]
    log({"int8_parity" if int8 else "parity": {
        "float32_logits_max_abs_err": f32_err, "float32_tol": TOL[torch.float32],
        **({"float32_int8_cache": int8_cache} if int8 else {}),
        "bf16_logits_max_abs_err": worst, "logit_range": float(ref[0].abs().max()),
        "bf16_per_step_kernel_plain_vs_f32": steps,
        "bf16_argmax_agree": f"{agree}/{len(lens) * len(bf_k)}",
        "engine_tokens_agree": f"{same}/{MAX_NEW * len(PROMPT_LENS)}",
        "engine_identical_prefix": prefix,
    }})


# --------------------------------------------------------- training kernels

# (label, B, T, H, KVH, D, dtype, causal, alibi); "main" is the training shape
TRAIN_CASES = [
    ("main", 8, 1024, 12, 12, 64, torch.bfloat16, True, True),
    ("f32", 2, 1024, 12, 12, 64, torch.float32, True, True),
    ("gqa", 2, 256, 8, 2, 64, torch.bfloat16, True, True),
    ("gqa_f32", 2, 256, 8, 2, 64, torch.float32, True, True),
    ("no_alibi_f32", 2, 192, 4, 4, 64, torch.float32, True, False),
    ("non_causal", 2, 320, 4, 4, 64, torch.bfloat16, False, True),
    ("non_causal_f32", 2, 320, 4, 4, 64, torch.float32, False, True),
    ("ragged_T", 2, 1000, 12, 12, 64, torch.bfloat16, True, True),
    ("ragged_T_f32", 1, 1000, 4, 4, 64, torch.float32, True, True),
    ("d128_gqa_f32", 1, 200, 4, 2, 128, torch.float32, True, True),
    ("d128_gqa", 1, 200, 4, 2, 128, torch.bfloat16, True, True),
    # 580m's one-card step at D 128: B 1, T 8192, 12 heads of 128
    ("d128_580m", 1, 8192, 12, 12, 128, torch.bfloat16, True, True),
    ("d128_ragged_T", 2, 1000, 4, 4, 128, torch.bfloat16, True, True),
    ("d128_non_causal", 2, 320, 4, 4, 128, torch.bfloat16, False, True),
]
# the timed cases and the suffix of their kernel-table rows: 125m's training
# shape (D 64) and 580m's one-card shape (D 128)
TIMED_TRAIN_CASES = {"main": "", "d128_580m": "_d128"}
# bf16 K2/K3 outputs against the float32 reference on the same o and lse:
# one bf16 ulp of the reference (the output's own rounding) plus GRAD_ATOL of
# the tensor's largest |grad|: the tensor-core path rounds p and ds to bf16
# for its second products. Set from readings on an H100: the worst output
# is 0.29-0.45 % of the largest |grad| (0.2-0.3 of a 1e-2 bar), while a
# causal limit one key off lands at 57-91x that bar.
GRAD_ATOL = 6e-3


def causal_pairs(T: int, causal: bool) -> int:
    """(query, key) pairs a head computes: T(T+1)/2 causal, T^2 otherwise."""
    return T * (T + 1) // 2 if causal else T * T


def train_bounds(B, T, H, KVH, D, dtype, causal, ids_bytes=0):
    """Least times (ms, bound_by) of K1 with lse, K2 and K3 on these inputs:
    bytes (each input read once, each output written once; ``ids_bytes`` of
    document ids) over HBM, or the products' flops over the (query, key)
    pairs the kernels visit, over the dtype's peak, whichever is larger."""
    el = torch.finfo(dtype).bits // 8
    qb, kb, row = B * T * H * D * el, B * T * KVH * D * el, B * H * T * 4
    pairs = B * H * causal_pairs(T, causal)
    work = {  # name: (bytes, flops)
        "flash_train_fwd": (2 * qb + 2 * kb + row + ids_bytes, 2 * 2 * D * pairs),
        "flash_dq": (3 * qb + 2 * kb + 2 * row + ids_bytes, 3 * 2 * D * pairs),
        "flash_dkv": (2 * qb + 4 * kb + 2 * row + ids_bytes, 4 * 2 * D * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        out[name] = (max(t_b, t_f), "bytes" if t_b >= t_f else "operations")
    return out


def shifted_bwd_reference(q, k, v, o, lse, do, alibi, shift):
    """flash_bwd_reference with the causal limit moved by ``shift`` keys
    (ALiBi unchanged): what a kernel one key off would compute."""
    from zero_transformer_tpu_torch.ops.flash import slopes_on
    from zero_transformer_tpu_torch.ops.positions import NEG_INF

    B, T, Hq, Dq = q.shape
    S = k.shape[1]
    G = Hq // k.shape[2]
    scale = 1.0 / Dq**0.5
    qf, dof = q.float(), do.float()
    kf, vf = k.float().repeat_interleave(G, 2), v.float().repeat_interleave(G, 2)
    dist = torch.arange(T, device=q.device)[:, None] - torch.arange(S, device=q.device)
    bias = torch.where(dist + shift >= 0, 0.0, NEG_INF)[None, None]
    if alibi:
        bias = bias - slopes_on(Hq, str(q.device), True)[None, :, None, None] * dist.clamp(min=0).float()
    p = torch.exp(torch.einsum("bthd,bshd->bhts", qf, kf) * scale + bias - lse[..., None])
    ds = p * (torch.einsum("bthd,bshd->bhts", dof, vf) - (dof * o.float()).sum(-1).transpose(1, 2)[..., None])
    dq = scale * torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = (scale * torch.einsum("bhts,bthd->bshd", ds, qf)).reshape(B, S, -1, G, Dq).sum(3)
    dv = torch.einsum("bhts,bthd->bshd", p, dof).reshape(B, S, -1, G, Dq).sum(3)
    return dq, dk, dv


def grad_miss(got, ref32) -> float:
    """max |got - ref| over its bar (one bf16 ulp of ref + GRAD_ATOL * max|ref|)."""
    err = (got.float() - ref32).abs()
    return float((err / (bf16_ulp(ref32) + GRAD_ATOL * float(ref32.abs().max()))).max())


def train_kernel_phase():
    """K1 (training entry, with lse), K2 and K3 against their plain versions."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.ops import flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    for label, B, T, Hq, KVH, Dq, dtype, causal, alibi in TRAIN_CASES:
        g = torch.Generator(device="cuda").manual_seed(len(label) + 100)
        q, k, v = (torch.randn(B, T, h, Dq, generator=g, device="cuda").to(dtype).requires_grad_()
                   for h in (Hq, KVH, KVH))
        do = torch.randn(B, T, Hq, Dq, generator=g, device="cuda").to(dtype)
        # the Function, forward and backward through autograd
        out = flash.flash_attention(q, k, v, causal=causal, alibi=alibi)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
        q, k, v = q.detach(), k.detach(), v.detach()
        # K1 with lse vs its plain version
        o_k, lse_k = flash._launch_fwd(q, k, v, causal=causal, alibi=alibi, q_offset=0,
                                       segment_ids=None, scale=1.0 / Dq**0.5, want_lse=True,
                                       counter=flash.TRAIN_KERNEL)
        torch.cuda.synchronize()
        if not torch.equal(o_k, out):
            raise AssertionError(f"train {label}: the Function's output differs from K1's")
        ref_o, ref_lse = flash.flash_reference(q, k, v, causal=causal, alibi=alibi)
        fwd_err = compare(out, ref_o, dtype, f"train fwd {label}")
        compare(lse_k, ref_lse, torch.float32 if dtype == torch.float32 else dtype, f"train lse {label}")
        # K2/K3 on the kernel's own o and lse vs the plain backward on the same
        got = flash.flash_bwd(q, k, v, o_k, lse_k, do, causal=causal, alibi=alibi)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, (dq, dk, dv))):
            raise AssertionError(f"train {label}: autograd grads differ from flash_bwd's")
        line = {"kernel": "flash_train", "case": label, "dtype": str(dtype), "fwd_max_err": fwd_err}
        if dtype == torch.float32:
            ref = flash.flash_bwd_reference(q, k, v, o_k, lse_k, do, causal=causal, alibi=alibi)
            errs = [compare(a, b, dtype, f"train {n} {label}") for n, a, b in zip(("dq", "dk", "dv"), got, ref)]
        else:
            ref = flash.flash_bwd_reference(q.float(), k.float(), v.float(), o_k.float(), lse_k,
                                            do.float(), causal=causal, alibi=alibi)
            misses = [grad_miss(a, b) for a, b in zip(got, ref)]
            if max(misses) > 1.0:
                raise AssertionError(f"train {label}: bf16 dq/dk/dv at {misses} of their bars")
            line["bf16_over_bar"] = misses
            line["bf16_err_over_max"] = [float((a.float() - b).abs().max() / b.abs().max())
                                         for a, b in zip(got, ref)]
            errs = [float((a.float() - b).abs().max()) for a, b in zip(got, ref)]
            if causal and label in TIMED_TRAIN_CASES:
                for shift in (1, -1):
                    off = shifted_bwd_reference(q, k, v, o_k, lse_k, do, alibi, shift)
                    s_miss = [grad_miss(a, b) for a, b in zip(got, off)]
                    if max(s_miss) <= 1.0:
                        raise AssertionError(f"train {label}: the causal-limit {shift:+d} reference passes "
                                             f"the bar ({s_miss}); the check cannot tell them apart")
                    line[f"causal_limit_{shift:+d}_over_bar"] = s_miss
        line.update(dq_max_err=errs[0], dk_max_err=errs[1], dv_max_err=errs[2])
        # the end-to-end Function against the whole plain path (its own o, lse)
        full = flash.flash_bwd_reference(q, k, v, ref_o, ref_lse, do, causal=causal, alibi=alibi)
        line["vs_plain_path_max_err"] = [compare(a, b, dtype, f"train e2e {n} {label}")
                                         for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), full)]
        log(line)
        if label not in TIMED_TRAIN_CASES:
            del full, ref
            continue
        suffix = TIMED_TRAIN_CASES[label]
        lse = lse_k.contiguous()
        delta = (do.float() * o_k.float()).sum(-1).transpose(1, 2).contiguous()
        scale = 1.0 / Dq**0.5
        check_deterministic(q, k, v, do, lse, delta, dict(causal=causal, alibi=alibi, scale=scale),
                            f"train {label}")
        kern = {
            "flash_train_fwd": lambda: flash._launch_fwd(
                q, k, v, causal=causal, alibi=alibi, q_offset=0, segment_ids=None, scale=scale,
                want_lse=True, counter=flash.TRAIN_KERNEL),
            "flash_dq": lambda: flash.launch_dq(q, k, v, do, lse, delta, causal=causal, alibi=alibi, scale=scale),
            "flash_dkv": lambda: flash.launch_dkv(q, k, v, do, lse, delta, causal=causal, alibi=alibi, scale=scale),
        }
        kern_ms = {n: time_ms(fn, iters=10) for n, fn in kern.items()}
        kern_dev = {n: device_ms(fn, iters=10) for n, fn in kern.items()}
        plain_fwd = time_ms(lambda: flash.flash_reference(q, k, v, causal=causal, alibi=alibi), iters=3)
        # the plain backward computes dq, dk and dv together: one time for K2 and K3
        plain_bwd = time_ms(lambda: flash.flash_bwd_reference(q, k, v, o_k, lse_k, do, causal=causal,
                                                              alibi=alibi), iters=3)
        bias = sdpa_bias(B, T, T, [0] * B, torch.ones(B, T, device="cuda", dtype=torch.int32), dtype)
        qt, kt, vt = (x.transpose(1, 2).requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), iters=10)
        # the library backward computes dq, dk and dv together: one time for K2 and K3
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), do.transpose(1, 2),
                                                      retain_graph=True), iters=10)
        bounds = train_bounds(B, T, Hq, KVH, Dq, dtype, causal)
        for name in kern:
            err = fwd_err if name == "flash_train_fwd" else (errs[0] if name == "flash_dq" else max(errs[1:]))
            bound, by = bounds[name]
            rows[name + suffix] = dict(max_abs_err=err, ms=kern_ms[name], device_ms=kern_dev[name],
                                       plain_ms=plain_fwd if name == "flash_train_fwd" else plain_bwd,
                                       library_ms=lib_fwd if name == "flash_train_fwd" else lib_bwd,
                                       bound_ms=bound, bound_by=by)
            log({"kernel": name + suffix, "shape": [B, T, Hq, KVH, Dq], **rows[name + suffix]})
        del lib_out, qt, kt, vt, bias, full, ref
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    return rows


def check_deterministic(q, k, v, do, lse, delta, kw, what: str) -> None:
    """K2 and K3 twice on the same inputs must write the same bits: each
    output tile is written once by one CTA, with no atomics (a resumed run
    is bit-equal only so)."""
    from zero_transformer_tpu_torch.ops import flash

    first = (flash.launch_dq(q, k, v, do, lse, delta, **kw),) + flash.launch_dkv(q, k, v, do, lse, delta, **kw)
    again = (flash.launch_dq(q, k, v, do, lse, delta, **kw),) + flash.launch_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(first, again)]
    log({"deterministic": what, "dq_dk_dv_bit_equal": same})
    if not all(same):
        raise AssertionError(f"{what}: two K2/K3 runs on the same inputs differ ({same})")


# ------------------------------------------------------------------ training

TRAIN_B, TRAIN_ACCUM, TRAIN_T = 8, 4, 1024
# set from readings on an H100 (see PERF.md): the kernel path's loss may be
# no farther from the float32 plain path than the bf16 plain path plus
# LOSS_MARGIN (read: 7.4e-5 vs 7.6e-6); every grad tensor's cosine to the
# float32 plain path at least COS_BAR (read: 0.99967 at the worst tensor,
# the bf16 plain path 0.99970); the loss over FALL_STEPS steps on one batch
# must fall by at least FALL_MARGIN (read: 3.6)
LOSS_MARGIN = 5e-4
COS_BAR = 0.999
# the repeated batch draws from the first FALL_VOCAB ids, so the loss can
# fall within a few steps (uniform ids over 50304 would leave ~0.4 nats)
FALL_STEPS, FALL_LR, FALL_MARGIN, FALL_VOCAB = 20, 1e-3, 2.0, 1024


def train_model(impl: str, dtype, state=None, name="125m"):
    from zero_transformer_tpu_torch.models import model_getter

    model = model_getter(name, dtype=dtype, device="cuda", seed=None if state else SEED,
                         trainable=True, attention_impl=impl)
    if state is not None:
        model.load_state_dict(state)
    return model


def loss_and_grads(model, tokens):
    _, loss = model(tokens, labels=tokens, train=True)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return float(loss), dict(zip(names, grads))


def train_parity(name: str, tokens) -> dict:
    """One micro-batch of ``name`` (seed-0 weights) through the kernels in
    bf16 and through the plain path (``attention_impl="xla"``) in bf16 and
    float32: fails unless the kernel loss is within LOSS_MARGIN of the bf16
    plain path's distance to float32 and every grad's cosine to the float32
    plain path is at least COS_BAR. Returns the readings and, under
    ``"state"``, the weights."""
    kmodel = train_model("auto", torch.bfloat16, name=name)
    state = {k: v.detach().clone() for k, v in kmodel.state_dict().items()}
    loss_k, grads_k = loss_and_grads(kmodel, tokens)
    del kmodel
    loss_x, grads_x = loss_and_grads(train_model("xla", torch.bfloat16, state, name), tokens)
    loss_f, grads_f = loss_and_grads(train_model("xla", torch.float32, state, name), tokens)
    torch.cuda.empty_cache()

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0))

    cos_k = {n: cos(grads_k[n], grads_f[n]) for n in grads_f}
    cos_x = {n: cos(grads_x[n], grads_f[n]) for n in grads_f}
    del grads_k, grads_x, grads_f
    parity = {"model": name, "loss_kernel": loss_k, "loss_plain_bf16": loss_x, "loss_plain_f32": loss_f,
              "kernel_vs_f32": abs(loss_k - loss_f), "plain_bf16_vs_f32": abs(loss_x - loss_f),
              "loss_margin": LOSS_MARGIN, "cos_bar": COS_BAR,
              "grad_cos_kernel_min": min(cos_k.values()), "grad_cos_plain_bf16_min": min(cos_x.values()),
              "grad_cos_kernel_min_tensor": min(cos_k, key=cos_k.get)}
    if not (math.isfinite(loss_k) and abs(loss_k - loss_f) <= abs(loss_x - loss_f) + LOSS_MARGIN):
        raise AssertionError(f"{name} parity: kernel loss {loss_k} vs f32 {loss_f}, bf16 plain {loss_x}")
    if min(cos_k.values()) < COS_BAR:
        raise AssertionError(f"{name} parity: grad cosines below {COS_BAR}: "
                             f"{ {n: c for n, c in cos_k.items() if c < COS_BAR} }")
    return {**parity, "state": state}


def train_profile(step, st, batch, steps: int = 2, label: str = "training_profile"):
    """Where an optimizer step's time goes: ``steps`` steps under
    ``torch.profiler``; device busy time (sum of kernel self time) against
    the steps' wall time, and the largest kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(st, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_times(prof)
    busy_ms = sum(ms for ms, _ in kernels.values())
    log({label: {
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps if kernels else "not measured",
        "device_busy_share": busy_ms / wall_ms if kernels else "not measured",
        "device_launches_per_step": sum(c for _, c in kernels.values()) / steps,
        "top_kernels_ms_per_step": top_kernels(kernels, 12, steps, 70),
    }})


def training_phase():
    """125m training through the kernels: parity with the plain path, the
    launch counts of one optimizer step, a falling loss, the trainer CLI."""
    import os

    from zero_transformer_tpu_torch.config import OptimizerConfig, model_config
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.parallel.zero import TrainState, make_train_step
    from zero_transformer_tpu_torch.training.optimizer import make_optimizer, make_schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(7)
    batch = torch.randint(0, 50304, (TRAIN_ACCUM, TRAIN_B, TRAIN_T), generator=g, device="cuda",
                          dtype=torch.int32)

    # (a) one micro-batch: kernels (bf16) vs the plain path in bf16 and float32
    parity = train_parity("125m", batch[0])
    state = parity.pop("state")
    log({"training_parity": parity})

    # (b) one optimizer step of B 8 x accum 4 x T 1024: launch counts
    batch = batch % FALL_VOCAB
    model = train_model("auto", torch.bfloat16, state)
    opt_cfg = OptimizerConfig(schedule="constant", peak_learning_rate=FALL_LR)
    schedule = make_schedule(opt_cfg)
    st = TrainState(step=0, model=model, optimizer=make_optimizer(model, opt_cfg, schedule))
    step = make_train_step(1, schedule)
    step(st, batch)  # warm-up: cuBLAS handles, the allocator
    torch.cuda.synchronize()
    _build.reset_launches()
    metrics = step(st, batch)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = 12 * TRAIN_ACCUM
    if any(launches[n] != want for n in ("flash_train_fwd", "flash_dq", "flash_dkv")):
        raise AssertionError(f"launches per optimizer step {launches}, want {want} each for the training kernels")

    # (c) the loss on one repeated batch at a constant lr must fall
    losses = [float(metrics["loss"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FALL_STEPS - 2):
        losses.append(float(step(st, batch)["loss"]))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (FALL_STEPS - 2)
    peak_mem = torch.cuda.max_memory_allocated() / 2**30
    log({"training_steps": {"losses": losses, "step_ms": step_ms, "lr": FALL_LR,
                            "tokens_per_step": TRAIN_ACCUM * TRAIN_B * TRAIN_T,
                            "peak_memory_gib": peak_mem, "launches_per_step": launches}})
    if not all(math.isfinite(x) for x in losses) or losses[-1] > losses[0] - FALL_MARGIN:
        raise AssertionError(f"loss did not fall by {FALL_MARGIN} over {FALL_STEPS} steps: {losses}")
    train_profile(step, st, batch)
    del st, model, step
    torch.cuda.empty_cache()

    # (d) the trainer CLI
    run_dir = os.path.join("chiprun_out", "train_125m")
    if os.path.exists(os.path.join(run_dir, "metrics.jsonl")):
        os.remove(os.path.join(run_dir, "metrics.jsonl"))
    cmd = [sys.executable, "-m", "zero_transformer_tpu_torch.train", "--cfg", "configs/train_125m.yaml",
           "--max-steps", "12", "--set", "data.source=synthetic", f"training.batch_size={TRAIN_B}",
           f"training.gradient_accumulation_steps={TRAIN_ACCUM}", "training.log_frequency=4",
           "training.evaluation_frequency=12", "training.maximum_evaluation_steps=2",
           f"checkpoint.directory={run_dir}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"trainer CLI exit {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train_recs = [r for r in records if "loss" in r]
    val = [r for r in records if "validation/loss" in r]
    if not train_recs or not val or not all(math.isfinite(r["loss"]) for r in train_recs):
        raise AssertionError(f"trainer CLI metrics incomplete or non-finite: {records}")
    last = train_recs[-1]
    n_params = model_config("125m").num_params
    log({"trainer_cli": {
        "wall_s": wall, "steps": last["step"], "loss": last["loss"],
        "validation_loss": val[-1]["validation/loss"],
        "tokens_per_sec": last["tokens_per_sec"], "step_time_ms": last["step_time_ms"],
        "model_flops_share": last.get("model_flops_share"),
        "model_flops_formula": f"tokens/s * 3 * (2 * N + 4 * L * d * T) / 989e12, N = {n_params}, "
                               "L = 12, d = 768, T = 1024",
    }})
    if last.get("model_flops_share") is None:
        raise AssertionError("the trainer CLI reported no model-FLOPs share on the card")
    return launches


# ------------------------------------------------------- packed documents

SEP = 0  # byte_25m's doc_sep_token
CTX = 512  # byte_25m's max_seq_len and train_e2e_bytes.yaml's context
HELDOUT_FRAC = 0.05  # scripts/e2e_quality.py's split
# (label, B, H, KVH, D, dtype); "main" is byte_25m's training shape
# (B 32, T = S 512, 8 heads of 64)
PACKED_CASES = [
    ("main", 32, 8, 8, 64, torch.bfloat16),
    ("f32", 32, 8, 8, 64, torch.float32),
    ("gqa", 10, 8, 2, 64, torch.bfloat16),
    ("gqa_f32", 10, 8, 2, 64, torch.float32),
    ("d128_f32", 10, 4, 4, 128, torch.float32),
    ("d128", 10, 4, 4, 128, torch.bfloat16),
]


@functools.lru_cache(maxsize=None)
def corpus():
    """The repo's own text, read from the tree (no ``.git`` needed):
    ``*.md``, ``docs/*.md``, then every ``.py``, as scripts/e2e_quality.py
    gathers text (:73-105): documents under 512 characters or holding a NUL
    are dropped, duplicates too, and a document goes to the held-out split
    when its hash says so. Returns ``(train, heldout)`` lists of str."""
    root = Path(__file__).resolve().parent
    skip = {"build", "runs"}  # build outputs and run directories (.gitignore)
    paths = sorted(root.glob("*.md")) + sorted(root.glob("docs/*.md")) + sorted(
        p for p in root.rglob("*.py")
        if not any(part in skip or part.startswith(".") for part in p.relative_to(root).parts[:-1])
    )
    seen, train, heldout = set(), [], []
    for p in paths:
        try:
            text = p.read_bytes().decode("utf-8")
        except UnicodeDecodeError:
            continue
        if len(text) < 512 or "\x00" in text:
            continue
        h = hashlib.sha256(text.encode()).hexdigest()
        if h in seen:
            continue
        seen.add(h)
        (heldout if int(h[:8], 16) / 0xFFFFFFFF < HELDOUT_FRAC else train).append(text)
    return train, heldout


def packed_rows(n: int):
    """``n`` [CTX] int32 rows of the packed train stream that hold a
    separator (a row holds at most one: every document has 512 bytes or more)."""
    from zero_transformer_tpu_torch.data.prepare import pack_rows
    from zero_transformer_tpu_torch.serve import ByteTokenizer

    rows = []
    for row in pack_rows(corpus()[0], ByteTokenizer(), CTX, SEP):
        if (row == SEP).any():
            rows.append(torch.from_numpy(row))
        if len(rows) == n:
            return torch.stack(rows)
    raise AssertionError(f"the corpus packs fewer than {n} rows with a separator")


def layout_rows():
    """[8, CTX] token rows whose separators make the document layouts the
    kernels must get right: a document starting at key 63, 64 or 65 (each
    side of the 64-key tile edge) and all three at once, separators at 0 and
    CTX - 1, twelve one-token documents, no separator, and many short
    documents of random lengths."""
    def row(seps):
        r = torch.full((CTX,), ord("a"), dtype=torch.int32)
        r[list(seps)] = SEP
        return r

    cuts = np.cumsum(np.random.default_rng(11).integers(1, 80, 64))
    return torch.stack([row([62]), row([63]), row([64]), row([62, 63, 64]), row([0, CTX - 1]),
                        row(range(200, 212)), row([]), row(cuts[cuts < CTX].tolist())])


def packed_sdpa_bias(docs, Hq, dtype):
    """[B, H, T, T] float bias: ALiBi + causal + the document mask."""
    from zero_transformer_tpu_torch.ops.positions import NEG_INF, alibi_slopes

    T = docs.shape[1]
    dist = torch.arange(T, device="cuda")[:, None] - torch.arange(T, device="cuda")
    bias = -alibi_slopes(Hq, "cuda")[None, :, None, None] * dist.clamp(min=0).float()
    bias = bias + torch.where(dist >= 0, 0.0, NEG_INF)
    bias = bias + torch.where(docs[:, :, None] == docs[:, None, :], 0.0, NEG_INF)[:, None]
    return bias.to(dtype)


def packed_kernel_phase():
    """K1 (with lse), K2 and K3 with the packed-document mask against their
    plain versions, on the layouts of ``layout_rows`` plus real packed rows
    of the corpus; the bars of the training-kernel phase, and a control:
    plain versions given inclusive-cumsum ids (each separator moved into
    the next document) must miss the bf16 bars."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.models.gpt import doc_ids_from_tokens
    from zero_transformer_tpu_torch.ops import flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    synthetic = layout_rows()
    real = packed_rows(max(c[1] for c in PACKED_CASES) - len(synthetic))
    rows = {}
    for label, B, Hq, KVH, Dq, dtype in PACKED_CASES:
        tokens = torch.cat([synthetic, real[: B - len(synthetic)]]).cuda()
        docs = doc_ids_from_tokens(tokens, SEP)
        inclusive = torch.cumsum((tokens == SEP).int(), 1, dtype=torch.int32)
        g = torch.Generator(device="cuda").manual_seed(len(label) + 300)
        q, k, v = (torch.randn(B, CTX, h, Dq, generator=g, device="cuda").to(dtype).requires_grad_()
                   for h in (Hq, KVH, KVH))
        do = torch.randn(B, CTX, Hq, Dq, generator=g, device="cuda").to(dtype)
        out = flash.flash_attention(q, k, v, causal=True, alibi=True, doc_ids=docs)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
        q, k, v, out = q.detach(), k.detach(), v.detach(), out.detach()
        scale = 1.0 / Dq**0.5
        o_k, lse_k = flash._launch_fwd(q, k, v, causal=True, alibi=True, q_offset=0, segment_ids=None,
                                       scale=scale, want_lse=True, counter=flash.TRAIN_KERNEL, doc_ids=docs)
        torch.cuda.synchronize()
        if not torch.equal(o_k, out):
            raise AssertionError(f"docs {label}: the Function's output differs from K1's")
        ref_o, ref_lse = flash.flash_reference(q, k, v, causal=True, alibi=True, doc_ids=docs)
        fwd_err = compare(out, ref_o, dtype, f"docs fwd {label}")
        compare(lse_k, ref_lse, torch.float32 if dtype == torch.float32 else dtype, f"docs lse {label}")
        line = {"kernel": "flash_train_docs", "case": label, "dtype": str(dtype),
                "shape": [B, CTX, Hq, KVH, Dq], "fwd_max_err": fwd_err}
        if dtype == torch.bfloat16:
            zeros = torch.zeros(B, dtype=torch.int32, device="cuda")
            ones = torch.ones(B, CTX, dtype=torch.int32, device="cuda")
            line["mma"] = check_mma(out, lse_k, q, k, v, zeros, ones, f"docs {label}", shifted=False,
                                    docs=docs, doc_control=inclusive, flip=True)
            # the same inputs without document ids miss the bar without the allowance too
            o_free, _ = flash._launch_fwd(q, k, v, causal=True, alibi=True, q_offset=0, segment_ids=None,
                                          scale=scale, want_lse=True, counter=flash.TRAIN_KERNEL)
            line["mma"]["no_docs_over_without_flip"] = mma_miss(
                o_free, flash_mma_emulation(q, k, v, zeros, ones)[0])[0]
            del o_free
        got = flash.flash_bwd(q, k, v, o_k, lse_k, do, causal=True, alibi=True, doc_ids=docs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, (dq, dk, dv))):
            raise AssertionError(f"docs {label}: autograd grads differ from flash_bwd's")
        if dtype == torch.float32:
            ref = flash.flash_bwd_reference(q, k, v, o_k, lse_k, do, causal=True, alibi=True, doc_ids=docs)
            errs = [compare(a, b, dtype, f"docs {n} {label}") for n, a, b in zip(("dq", "dk", "dv"), got, ref)]
        else:
            f32 = (q.float(), k.float(), v.float(), o_k.float(), lse_k, do.float())
            ref = flash.flash_bwd_reference(*f32, causal=True, alibi=True, doc_ids=docs)
            misses = [grad_miss(a, b) for a, b in zip(got, ref)]
            if max(misses) > 1.0:
                raise AssertionError(f"docs {label}: bf16 dq/dk/dv at {misses} of their bars")
            control = flash.flash_bwd_reference(*f32, causal=True, alibi=True, doc_ids=inclusive)
            c_miss = [grad_miss(a, b) for a, b in zip(got, control)]
            if max(c_miss) <= 1.0:
                raise AssertionError(f"docs {label}: the inclusive-id reference passes the bar ({c_miss}); "
                                     "the check cannot tell them apart")
            line.update(bf16_over_bar=misses, inclusive_doc_ids_over_bar=c_miss)
            errs = [float((a.float() - b).abs().max()) for a, b in zip(got, ref)]
            del control, f32
        line.update(dq_max_err=errs[0], dk_max_err=errs[1], dv_max_err=errs[2])
        full = flash.flash_bwd_reference(q, k, v, ref_o, ref_lse, do, causal=True, alibi=True, doc_ids=docs)
        line["vs_plain_path_max_err"] = [compare(a, b, dtype, f"docs e2e {n} {label}")
                                         for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), full)]
        causal_pairs_all = B * causal_pairs(CTX, True)
        causal = torch.ones(CTX, CTX, dtype=torch.bool, device="cuda").tril()
        same = (docs[:, :, None] == docs[:, None, :]) & causal
        line["doc_visible_pair_share"] = float(same.sum()) / causal_pairs_all
        log(line)
        del full, ref
        if label != "main":
            continue
        lse = lse_k.contiguous()
        delta = (do.float() * o_k.float()).sum(-1).transpose(1, 2).contiguous()
        kern = {
            "flash_train_fwd_docs": lambda: flash._launch_fwd(
                q, k, v, causal=True, alibi=True, q_offset=0, segment_ids=None, scale=scale,
                want_lse=True, counter=flash.TRAIN_KERNEL, doc_ids=docs),
            "flash_dq_docs": lambda: flash.launch_dq(q, k, v, do, lse, delta, causal=True, alibi=True,
                                                     scale=scale, doc_ids=docs),
            "flash_dkv_docs": lambda: flash.launch_dkv(q, k, v, do, lse, delta, causal=True, alibi=True,
                                                       scale=scale, doc_ids=docs),
        }
        kern_ms = {n: time_ms(fn, iters=10) for n, fn in kern.items()}
        kern_dev = {n: device_ms(fn, iters=10) for n, fn in kern.items()}
        # the same kernels on the same inputs without the mask: what the mask costs
        free_ms = {
            "flash_train_fwd_docs": time_ms(lambda: flash._launch_fwd(
                q, k, v, causal=True, alibi=True, q_offset=0, segment_ids=None, scale=scale,
                want_lse=True, counter=flash.TRAIN_KERNEL), iters=10),
            "flash_dq_docs": time_ms(lambda: flash.launch_dq(q, k, v, do, lse, delta, causal=True, alibi=True,
                                                             scale=scale), iters=10),
            "flash_dkv_docs": time_ms(lambda: flash.launch_dkv(q, k, v, do, lse, delta, causal=True, alibi=True,
                                                               scale=scale), iters=10),
        }
        plain_fwd = time_ms(lambda: flash.flash_reference(q, k, v, causal=True, alibi=True, doc_ids=docs),
                            iters=3)
        # the plain backward computes dq, dk and dv together: one time for K2 and K3
        plain_bwd = time_ms(lambda: flash.flash_bwd_reference(q, k, v, o_k, lse_k, do, causal=True, alibi=True,
                                                              doc_ids=docs), iters=3)
        bias = packed_sdpa_bias(docs, Hq, dtype)
        qt, kt, vt = (x.transpose(1, 2).requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), iters=10)
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), do.transpose(1, 2),
                                                      retain_graph=True), iters=10)
        bounds = train_bounds(B, CTX, Hq, KVH, Dq, dtype, True, ids_bytes=4 * B * CTX)
        for name in kern:
            err = fwd_err if name == "flash_train_fwd_docs" else (errs[0] if name == "flash_dq_docs"
                                                                  else max(errs[1:]))
            bound, by = bounds[name.removesuffix("_docs")]
            rows[name] = dict(max_abs_err=err, ms=kern_ms[name], device_ms=kern_dev[name],
                              plain_ms=plain_fwd if name == "flash_train_fwd_docs" else plain_bwd,
                              library_ms=lib_fwd if name == "flash_train_fwd_docs" else lib_bwd,
                              bound_ms=bound, bound_by=by)
            log({"kernel": name, "shape": [B, CTX, Hq, KVH, Dq], "ms_without_docs": free_ms[name],
                 "doc_visible_pair_share": line["doc_visible_pair_share"], **rows[name]})
        del lib_out, qt, kt, vt, bias
    torch.cuda.empty_cache()
    return rows


def heldout_tasks(heldout, max_lambada: int = 400):
    """The last-word and choice examples of scripts/e2e_quality.py
    (``build_eval_files``, :116-199) at context 512, as token lists. The
    held-out documents follow from file hashes, so a task may come out
    empty (fewer than four paragraphs give no choice examples); its
    accuracy is then reported over 0 examples and nothing is scored."""
    lastword = []
    for doc in heldout:
        for para in doc.split("\n\n"):
            para = para.strip()
            words = para.split()
            if not (12 <= len(words) <= 80) or len(para) > 1200:
                continue
            last = words[-1]
            if not re.fullmatch(r"[A-Za-z][A-Za-z'\-]{2,}[.:,;]?", last):
                continue
            lastword.append((list(para[: len(para) - len(last) - 1].encode()), list((" " + last).encode())))
            if len(lastword) >= max_lambada:
                break
        if len(lastword) >= max_lambada:
            break
    paras = [p.strip() for doc in heldout for p in doc.split("\n\n") if 200 <= len(p.strip()) <= 900]
    if len(paras) < 4:
        return lastword, []
    cap = max(32, CTX // 2 - 8)

    def second_half(s):
        cut = s.find(" ", len(s) // 2)
        cut = cut if cut != -1 else len(s) // 2
        return s[:cut], s[cut:]

    def cap_b(s):
        return s.encode()[:cap].decode("utf-8", errors="ignore")

    choice = []
    for i, para in enumerate(paras[: 20 if len(paras) < 100 else 200]):
        context, true_cont = second_half(para)
        cands = [cap_b(true_cont), cap_b(second_half(paras[(i + 1) % len(paras)])[1]),
                 cap_b(second_half(paras[(i + 2) % len(paras)])[1])]
        gold = i % 3
        cands[0], cands[gold] = cands[gold], cands[0]
        choice.append((list(context.encode()), [list(c.encode()) for c in cands], gold,
                       [len(c.encode()) for c in cands]))
    return lastword, choice


def unigram_entropy_nats(data: bytes) -> float:
    counts = np.bincount(np.frombuffer(data, np.uint8), minlength=256).astype(np.float64)
    p = counts[counts > 0] / counts.sum()
    return float(-(p * np.log(p)).sum())


# the packed run: configs/train_e2e_bytes.yaml with these changes only
PACKED_STEPS, PACKED_WARMUP, PACKED_EVAL_EVERY, EVAL_BATCH = 300, 30, 300, 32
BPB_GAP = 0.01  # kernel-path bits per byte within this of the plain path's


def packed_phase():
    """byte_25m at full width and depth on the repo's own text: the port's
    prepare writes tar shards, the kernel path meets the plain path on one
    packed batch, the trainer runs train_e2e_bytes.yaml, the eval harness
    scores the trained model, and the trainer CLI takes a few steps."""
    import shutil

    from zero_transformer_tpu_torch.config import apply_dotted_overrides, load_config, model_config
    from zero_transformer_tpu_torch.data import make_loader, prepare
    from zero_transformer_tpu_torch.evalharness import choice_accuracy, lambada, perplexity
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parent
    yaml_path = root / "configs" / "train_e2e_bytes.yaml"
    out = root / "build" / "packed"
    shutil.rmtree(out, ignore_errors=True)
    data = out / "data"
    data.mkdir(parents=True)

    # 1. corpus -> the port's prepare CLI -> tar shards
    t0 = time.perf_counter()
    train_docs, heldout = corpus()
    for name, docs in (("train", train_docs), ("heldout", heldout)):
        with open(data / f"{name}.jsonl", "w") as f:
            f.writelines(json.dumps({"text": d}) + "\n" for d in docs)
    for split, src in (("train", "train.jsonl"), ("val", "heldout.jsonl")):
        prepare.main(["--input", str(data / src), "--tokenizer", "bytes", "--max-context", str(CTX),
                      "--format", "tar", "--doc-sep", str(SEP), "--rows-per-shard", "512",
                      "--out", str(data / split)])
    stream = "\n\n".join(heldout)[:400_000].encode()
    entropy = unigram_entropy_nats(stream)
    log({"packed_corpus": {
        "train_docs": len(train_docs), "heldout_docs": len(heldout),
        "train_bytes": sum(len(d.encode()) for d in train_docs), "heldout_stream_bytes": len(stream),
        "heldout_unigram_entropy_nats": entropy, "heldout_unigram_entropy_bits": entropy / math.log(2),
        "prepare_s": time.perf_counter() - t0}})

    overrides = {
        "data.train_path": str(data / "train.index"), "data.validation_path": str(data / "val.index"),
        "training.total_steps": PACKED_STEPS, "optimizer.warmup_steps": PACKED_WARMUP,
        "training.evaluation_frequency": PACKED_EVAL_EVERY, "checkpoint.directory": str(out / "run"),
    }
    cfg = apply_dotted_overrides(load_config(yaml_path), overrides)

    # 2. parity on one packed micro-batch
    it = iter(make_loader(cfg))
    batch = torch.from_numpy(next(it)[0]).cuda()
    it.close()
    parity = train_parity("byte_25m", batch)
    del parity["state"]
    log({"packed_parity": parity})

    # 3. training; the launch counts are zeroed just before and read just after
    trainer = Trainer(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        trainer.close()
    eval_batches = PACKED_STEPS // PACKED_EVAL_EVERY * cfg.training.maximum_evaluation_steps
    want = {"flash_train_fwd_docs": 8 * (PACKED_STEPS + eval_batches), "flash_dq_docs": 8 * PACKED_STEPS,
            "flash_dkv_docs": 8 * PACKED_STEPS, "flash_train_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    if any(launches[n] != c for n, c in want.items()):
        raise AssertionError(f"packed launches {launches}, want {want} (8 per step and per eval batch)")
    with open(out / "run" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    train_recs = [r for r in records if "loss" in r]
    val = [r for r in records if "validation/loss" in r]
    last = train_recs[-1]
    n_params = model_config("byte_25m").num_params
    log({"packed_training": {
        "overrides": overrides, "steps": last["step"], "wall_s": train_wall,
        "tokens_per_step": cfg.training.batch_size * cfg.training.train_context,
        "losses": [(r["step"], r["loss"]) for r in train_recs],
        "validation_loss": val[-1]["validation/loss"], "heldout_unigram_entropy_nats": entropy,
        "step_time_ms": last["step_time_ms"], "tokens_per_sec": last["tokens_per_sec"],
        "model_flops_share": last.get("model_flops_share"),
        "model_flops_formula": f"tokens/s * 3 * (2 * N + 4 * L * d * T) / 989e12, N = {n_params}, "
                               "L = 8, d = 512, T = 512",
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "want": want, "eval_batches": eval_batches,
    }})
    if not all(math.isfinite(r["loss"]) for r in train_recs) or not val[-1]["validation/loss"] < entropy:
        raise AssertionError(f"validation loss {val[-1]['validation/loss']} not below the held-out unigram "
                             f"entropy {entropy} nats")

    # 4. the eval harness on the trained model, and bpb through the plain path
    model = trainer.state.model
    lastword, choice = heldout_tasks(heldout)
    tokens = list(stream)
    t0 = time.perf_counter()
    bpb = perplexity(model, tokens, CTX, EVAL_BATCH, num_bytes=len(tokens))
    lam = lambada(model, lastword, CTX, EVAL_BATCH)
    cho = choice_accuracy(model, choice, CTX, EVAL_BATCH) if choice else {"examples": 0}
    eval_s = time.perf_counter() - t0
    plain = train_model("xla", torch.bfloat16, {k: v.detach() for k, v in model.state_dict().items()},
                        "byte_25m")
    bpb_plain = perplexity(plain, tokens, CTX, EVAL_BATCH, num_bytes=len(tokens))
    del plain
    entropy_bits = entropy / math.log(2)
    log({"packed_eval": {
        "bits_per_byte": bpb["bits_per_byte"], "bits_per_byte_plain": bpb_plain["bits_per_byte"],
        "unigram_entropy_bits": entropy_bits, "byte_ppl": bpb["ppl"], "scored_bytes": bpb["tokens"],
        "lastword": lam, "choice": cho, "eval_s": eval_s}})
    if not bpb["bits_per_byte"] < entropy_bits:
        raise AssertionError(f"bits per byte {bpb['bits_per_byte']} not below the unigram entropy {entropy_bits}")
    if abs(bpb["bits_per_byte"] - bpb_plain["bits_per_byte"]) > BPB_GAP:
        raise AssertionError(f"kernel-path bpb {bpb['bits_per_byte']} vs plain {bpb_plain['bits_per_byte']}")
    packed_int8(model, heldout, tokens, bpb["bits_per_byte"], out)
    # two more steps under the profiler, after the eval has scored the run
    train_profile(trainer.train_step, trainer.state, batch[None], label="packed_training_profile")
    del trainer, model
    torch.cuda.empty_cache()

    # 5. the trainer CLI on the same shards
    cli_dir = out / "cli"
    cmd = [sys.executable, "-m", "zero_transformer_tpu_torch.train", "--cfg", str(yaml_path), "--max-steps", "20",
           "--set", f"data.train_path={data / 'train.index'}", f"data.validation_path={data / 'val.index'}",
           f"checkpoint.directory={cli_dir}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"trainer CLI exit {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(cli_dir / "metrics.jsonl") as f:
        cli_recs = [r for r in map(json.loads, f) if "loss" in r]
    if not cli_recs or not all(math.isfinite(r["loss"]) for r in cli_recs):
        raise AssertionError(f"packed trainer CLI metrics incomplete or non-finite: {cli_recs}")
    log({"packed_trainer_cli": {"wall_s": wall, "steps": cli_recs[-1]["step"], "loss": cli_recs[-1]["loss"],
                                "tokens_per_sec": cli_recs[-1]["tokens_per_sec"],
                                "step_time_ms": cli_recs[-1]["step_time_ms"],
                                "model_flops_share": cli_recs[-1].get("model_flops_share")}})
    return launches


# JAX's budget for weight-only int8 (tests/test_quant.py::test_quant_perplexity_budget):
# perplexity within 2 %, so bits per byte within log2(1.02)
INT8_BPB_BUDGET = math.log2(1.02)


def packed_int8(model, heldout, tokens, bpb_bf16: float, out: Path) -> None:
    """The trained byte_25m with weight-only int8: bits per byte on the
    held-out stream within INT8_BPB_BUDGET of the bf16 value; then eight
    held-out prompts served in-process by the engine twice, in bf16 and
    with int8 KV plus int8 weights, greedy, 32 tokens each: the share of
    tokens before each stream's first divergence (no bar). Then the CLIs a
    user runs, on an ``.npz`` of the same weights: the eval harness with
    ``--quantize int8`` must give the same bits per byte, and the server
    with ``--kv-cache-dtype int8 --quantize int8`` must answer a request
    through K4's int8 branch."""
    from zero_transformer_tpu_torch.convert import params_to_jax
    from zero_transformer_tpu_torch.evalharness import perplexity
    from zero_transformer_tpu_torch.models import model_getter
    from zero_transformer_tpu_torch.models.quant import quantize_model

    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    qmodel = model_getter("byte_25m", dtype=torch.bfloat16, device="cuda")
    qmodel.load_state_dict(state)
    qmodel = quantize_model(qmodel)
    bpb_q = perplexity(qmodel, tokens, CTX, EVAL_BATCH, num_bytes=len(tokens))["bits_per_byte"]
    del qmodel
    paras = [p.strip() for doc in heldout for p in doc.split("\n\n") if 120 <= len(p.strip().encode()) <= 400]
    if len(paras) < 8:
        raise AssertionError(f"the held-out text gives {len(paras)} prompts of 120-400 bytes, want 8")
    prompts = [list(p.encode()) for p in paras[:8]]
    streams = {}
    for label, int8 in (("bf16", False), ("int8", True)):
        engine = build_engine("auto", name="byte_25m", state=state, cache_len=CTX, **(INT8 if int8 else {}))
        handles = [engine.submit(p, max_new_tokens=MAX_NEW, seed=i) for i, p in enumerate(prompts)]
        engine.run_until_idle()
        if any(h.status != "done" or len(h.tokens) != MAX_NEW for h in handles):
            raise AssertionError(f"byte_25m {label} serving: {[(h.status, len(h.tokens)) for h in handles]}")
        streams[label] = [h.tokens for h in handles]
        del engine
    prefix = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), MAX_NEW)
              for x, y in zip(streams["bf16"], streams["int8"])]
    log({"packed_int8": {
        "bits_per_byte_bf16": bpb_bf16, "bits_per_byte_int8_weights": bpb_q, "gap": bpb_q - bpb_bf16,
        "budget": INT8_BPB_BUDGET, "served_prompts": len(prompts), "prompt_bytes": [len(p) for p in prompts],
        "agree_before_first_divergence": sum(prefix) / (MAX_NEW * len(prompts)),
        "identical_prefix_per_prompt": prefix}})
    if not bpb_q <= bpb_bf16 + INT8_BPB_BUDGET:
        raise AssertionError(f"int8-weight bits per byte {bpb_q} beyond bf16 {bpb_bf16} + {INT8_BPB_BUDGET}")
    torch.cuda.empty_cache()

    # the CLIs, each quantizing the .npz's float32 tree on the host
    npz = out / "byte_25m.npz"
    np.savez(npz, **params_to_jax(state))
    data = out / "heldout_ppl.json"
    data.write_text(json.dumps({"tokens": tokens, "num_bytes": len(tokens)}))
    cmd = [sys.executable, "-m", "zero_transformer_tpu_torch.evalharness", "--model", "byte_25m", "--params",
           str(npz), "--task", "bpb", "--data", str(data), "--seq-len", str(CTX), "--batch-size", str(EVAL_BATCH),
           "--quantize", "int8"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=Path(__file__).resolve().parent)
    if proc.returncode != 0:
        raise AssertionError(f"eval CLI exit {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    if not cli["device"].startswith("cuda") or abs(cli["bits_per_byte"] - bpb_q) > CLI_BPB_ATOL:
        raise AssertionError(f"eval CLI --quantize int8: {cli} vs in-process {bpb_q}")
    served = serve_cli(npz, paras[0])
    log({"packed_int8_clis": {"eval_bits_per_byte": cli["bits_per_byte"], "in_process": bpb_q,
                              "serve": served, "serve_tokens_agree_with_engine": sum(
                                  int(a == b) for a, b in zip(served["tokens"], streams["int8"][0]))}})


# the eval CLI's bits per byte on the .npz against the in-process model's:
# the same int8 weights and the same batches, so equal but for the order in
# which cuBLAS may sum in another process
CLI_BPB_ATOL = 1e-5


def serve_cli(npz: Path, prompt: str) -> dict:
    """``python -m zero_transformer_tpu_torch.serve --server --kv-cache-dtype
    int8 --quantize int8`` on byte_25m's ``.npz``, in a process of its own on
    a free port: one greedy request of 32 tokens, then ``/metrics``; the
    server is stopped with SIGINT (and killed if it does not stop)."""
    import queue
    import signal

    cmd = [sys.executable, "-m", "zero_transformer_tpu_torch.serve", "--model", "byte_25m", "--params", str(npz),
           "--server", "--port", "0", "--cache-len", str(CTX), "--kv-cache-dtype", "int8", "--quantize", "int8",
           "--greedy"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=Path(__file__).resolve().parent)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    try:
        base, seen, deadline = None, [], time.monotonic() + 300
        while base is None:
            try:
                line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"serve CLI printed no address within 300 s: {seen[-20:]}") from None
            seen.append(line)
            found = re.search(r"serving on (http://[0-9.]+:[0-9]+)", line)
            base = found.group(1) if found else None
            if proc.poll() is not None and base is None and lines.empty():
                raise AssertionError(f"serve CLI exit {proc.returncode}: {seen[-20:]}")
        for _ in range(600):
            try:
                if http("GET", base + "/healthz", timeout=10)[0] == 200:
                    break
            except urllib.error.HTTPError:
                time.sleep(0.05)
        code, text = http("POST", base + "/generate", {"prompt": prompt, "max_new_tokens": MAX_NEW,
                                                      "stream": False})
        doc = json.loads(text)
        metrics = json.loads(http("GET", base + "/metrics")[1])
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    launches = metrics["kernel_launches"]
    if code != 200 or doc["status"] != "done" or len(doc["tokens"]) != MAX_NEW:
        raise AssertionError(f"serve CLI request: HTTP {code}, {doc}")
    if (metrics["kv_cache_dtype"], metrics["param_quant"]) != ("int8", "int8") or not (
            launches["paged_attention_int8"] > 0 and launches["flash_serving_fwd"] > 0
            and launches["paged_attention"] == 0) or not metrics["device"].startswith("cuda"):
        raise AssertionError(f"serve CLI did not serve int8 through the kernels: {metrics}")
    return {"tokens": doc["tokens"], "device": metrics["device"], "kv_pool_bytes": metrics["kv_pool_bytes"],
            "weight_bytes": metrics["weight_bytes"], "launches": {k: v for k, v in launches.items() if v},
            "exit": proc.returncode}


# ------------------------------------------------- sequence-parallel kernels

SP_T = 2048  # 580m's shard: T 8192 over 4 ranks
# (label, B, t, H, KVH, D, dtype, docs); "main" is 580m's ring shape
SP_CASES = [
    ("main", 1, SP_T, 12, 12, 128, torch.bfloat16, False),
    ("main_docs", 1, SP_T, 12, 12, 128, torch.bfloat16, True),
    ("main_f32", 1, SP_T, 12, 12, 128, torch.float32, True),
    ("gqa", 2, 256, 8, 2, 128, torch.bfloat16, True),
    ("gqa_f32", 2, 256, 8, 2, 128, torch.float32, True),
    ("d64", 2, 256, 4, 4, 64, torch.bfloat16, True),
    ("d64_f32", 2, 256, 4, 4, 64, torch.float32, False),
]
# (query shard, key shard) of a 3-shard sequence
SP_PAIRS = {"diagonal": (1, 1), "past": (2, 1), "future": (0, 2)}
MASKED_LSE = -1e9  # a row with no visible key of its document has lse ~ -1e10 or -1e30


def sp_doc_ids(B: int, T: int) -> torch.Tensor:
    """[B, T] exclusive-cumsum document ids whose documents span both shard
    boundaries of a 3-shard row, and some that start inside a shard."""
    sep = torch.zeros(B, T, dtype=torch.int32)
    for b in range(B):
        for f in (0.05, 0.3, 0.45, 0.6, 0.62, 0.9):
            sep[b, int(f * T) + 7 * b] = 1
    return (torch.cumsum(sep, 1) - sep).to(torch.int32).cuda()


def partial_bounds(B, t, H, KVH, D, dtype, pairs, ids_bytes):
    """Least times (ms, bound_by) of flash_partial's K1 (f32 out + lse) and
    flash_grads' K2 and K3 (f32 grads) on one shard pair: bytes (inputs read
    once, outputs written once) over HBM, or the products' flops over the
    (query, key) pairs the causal limit admits, over the input dtype's peak."""
    el = torch.finfo(dtype).bits // 8
    qb, kb, row = B * t * H * D * el, B * t * KVH * D * el, B * H * t * 4
    q32, k32 = B * t * H * D * 4, B * t * KVH * D * 4
    work = {  # name: (bytes, flops)
        "flash_partial_fwd": (qb + 2 * kb + q32 + row + ids_bytes, 2 * 2 * D * B * H * pairs),
        "flash_partial_dq": (2 * qb + 2 * kb + 2 * row + q32 + ids_bytes, 3 * 2 * D * B * H * pairs),
        "flash_partial_dkv": (2 * qb + 2 * kb + 2 * row + 2 * k32 + ids_bytes, 4 * 2 * D * B * H * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        out[name] = (max(t_b, t_f), "bytes" if t_b >= t_f else "operations")
    return out


def sp_sdpa_bias(q_off, kv_off, t, Hq, q_ids, k_ids, dtype):
    from zero_transformer_tpu_torch.ops.positions import NEG_INF, alibi_slopes

    dist = (q_off + torch.arange(t, device="cuda"))[:, None] - (kv_off + torch.arange(t, device="cuda"))
    bias = -alibi_slopes(Hq, "cuda")[:, None, None] * dist.clamp(min=0).float()
    bias = (bias + torch.where(dist >= 0, 0.0, NEG_INF))[None]
    if q_ids is not None:
        bias = bias + torch.where(q_ids[:, :, None] == k_ids[:, None, :], 0.0, NEG_INF)[:, None]
    return bias.to(dtype)


def sp_kernel_phase():
    """flash_partial (K1 at global offsets, f32 out) and flash_grads (K2/K3
    at global offsets given the global lse and delta, f32 grads) against
    their plain versions, on the diagonal, a past and a future shard of a
    3-shard sequence, with and without separate query and key document ids;
    f32 within atol 1e-4; bf16 forward within MMA_ATOL plus one p-rounding
    flip of the f32-output emulation of its rounding and its lse within
    MMA_LSE_ATOL, bf16 grads within one
    bf16 ulp + GRAD_ATOL of the largest |grad| (the training bars), each bf16
    bar rejecting a plain version one key off in kv_offset and (past shard,
    ids) one that reads the query ids as key ids; a future shard writes
    o = 0, lse = -1e30 and zero grads exactly. Rows that see no key of their
    own document in a shard (lse near -1e10) carry weight exp(lse - m) = 0
    in the ring's merge: their lse must be masked in both, their o is not
    compared (its value, a mean over keys whose scores round to the same
    multiple of 1024 near -1e10, is not part of the function)."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.ops import flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    for label, B, t, Hq, KVH, Dq, dtype, docs in SP_CASES:
        g = torch.Generator(device="cuda").manual_seed(len(label) + 500)
        T = 3 * t
        q, k, v, do = (torch.randn(B, T, h, Dq, generator=g, device="cuda").to(dtype)
                       for h in (Hq, KVH, KVH, Hq))
        ids = sp_doc_ids(B, T) if docs else None
        scale = 1.0 / Dq**0.5
        # the global out and lse of the whole sequence, as the ring hands them to flash_grads
        o_all, lse_all = flash._launch_fwd(q, k, v, causal=True, alibi=True, q_offset=0, segment_ids=None,
                                           scale=scale, want_lse=True, counter=flash.TRAIN_KERNEL, doc_ids=ids)

        def cut(x, i, dim=1):
            return None if x is None else x.narrow(dim, i * t, t).contiguous()

        for pair, (qi, ki) in SP_PAIRS.items():
            qs, ks, vs, dos = cut(q, qi), cut(k, ki), cut(v, ki), cut(do, qi)
            q_ids, k_ids = cut(ids, qi), cut(ids, ki)
            at = dict(causal=True, alibi=True, softmax_scale=scale, q_offset=qi * t, kv_offset=ki * t)
            o_k, lse_k = flash.flash_partial(qs, ks, vs, **at, q_ids=q_ids, k_ids=k_ids)
            ref_o, ref_lse = flash.flash_partial_reference(qs, ks, vs, **at, q_ids=q_ids, k_ids=k_ids)
            torch.cuda.synchronize()
            if o_k.dtype != torch.float32 or lse_k.dtype != torch.float32:
                raise AssertionError(f"sp {label} {pair}: flash_partial wrote {o_k.dtype}/{lse_k.dtype}")
            live = ref_lse > MASKED_LSE  # [B, H, t]
            if not torch.equal(lse_k > MASKED_LSE, live):
                raise AssertionError(f"sp {label} {pair}: the kernel masks other rows than the plain version")
            live_o = live.transpose(1, 2)[..., None].expand_as(o_k)
            line = {"kernel": "flash_partial", "case": label, "pair": pair, "dtype": str(dtype),
                    "shape": [B, t, Hq, KVH, Dq], "live_row_share": float(live.float().mean())}
            line["fwd_max_err"] = compare(o_k[live_o], ref_o[live_o], torch.float32 if dtype == torch.float32
                                          else dtype, f"sp fwd {label} {pair}")
            compare(lse_k[live], ref_lse[live], torch.float32 if dtype == torch.float32 else dtype,
                    f"sp lse {label} {pair}")
            if pair == "future" and not (bool((o_k == 0).all()) and bool((lse_k == flash.INIT_M).all())):
                raise AssertionError(f"sp {label}: a future shard must write o = 0 and lse = -1e30")
            if dtype == torch.bfloat16:
                emu, emu_lse, flip = flash_mma_emulation(qs, ks, vs, qi * t, torch.ones(B, t, device="cuda"),
                                                         q_ids, with_flip=True, kv_offsets=ki * t,
                                                         k_docs=k_ids, round_out=False)

                def over(e):
                    return float(((o_k - e).abs() / (MMA_ATOL + flip))[live_o].max()) if bool(live.any()) else 0.0

                miss, lse_err = over(emu), float((lse_k - emu_lse)[live].abs().max()) if bool(live.any()) else 0.0
                if miss > 1.0 or lse_err > MMA_LSE_ATOL:
                    raise AssertionError(f"sp {label} {pair}: {miss} of the emulation bar, lse {lse_err}")
                line["mma"] = {"max_err_over_bar": miss, "lse_max_abs_err": lse_err}
                controls = {}
                if pair != "future":
                    controls["kv_offset_plus_1"] = dict(kv_offsets=ki * t + 1, k_docs=k_ids)
                if pair == "past" and docs:
                    controls["q_ids_as_k_ids"] = dict(kv_offsets=ki * t, k_docs=q_ids)
                for what, kw in controls.items():
                    # a past shard's keys all lie behind its queries: one key
                    # off moves every ALiBi bias of a row alike, so o cannot
                    # tell, but the lse the ring merges by does
                    c_o, c_lse = flash_mma_emulation(qs, ks, vs, qi * t, torch.ones(B, t, device="cuda"), q_ids,
                                                     round_out=False, **kw)
                    c_miss, c_lse_err = over(c_o), float((lse_k - c_lse)[live].abs().max())
                    if c_miss <= 1.0 and c_lse_err <= MMA_LSE_ATOL:
                        raise AssertionError(f"sp {label} {pair}: the {what} control passes the bars "
                                             f"({c_miss}, lse {c_lse_err})")
                    line["mma"][what] = {"max_err_over_bar": c_miss, "lse_max_abs_err": c_lse_err}
                del emu, flip

            # backward against the global o and lse, delta from the caller
            o_g, lse_g = cut(o_all, qi), cut(lse_all, qi, dim=2)
            delta = (dos.float() * o_g.float()).sum(-1).transpose(1, 2).contiguous()
            got = flash.flash_grads(qs, ks, vs, o_g, lse_g, dos, **at, delta=delta, q_ids=q_ids, k_ids=k_ids)
            f32_in = [x.float() for x in (qs, ks, vs, o_g)] + [lse_g, dos.float()]
            ref = flash.flash_grads_reference(*f32_in, **at, delta=delta, q_ids=q_ids, k_ids=k_ids)
            torch.cuda.synchronize()
            if any(x.dtype != torch.float32 for x in got):
                raise AssertionError(f"sp {label} {pair}: flash_grads wrote {[x.dtype for x in got]}")
            if pair == "future" and any(bool(x.any()) for x in got):
                raise AssertionError(f"sp {label}: a future shard's grads must be exactly 0")
            if dtype == torch.float32:
                errs = [compare(a, b, dtype, f"sp {n} {label} {pair}") for n, a, b in zip(("dq", "dk", "dv"), got, ref)]
            else:
                misses = [grad_miss(a, b) for a, b in zip(got, ref)]
                if max(misses) > 1.0:
                    raise AssertionError(f"sp {label} {pair}: bf16 dq/dk/dv at {misses} of their bars")
                line["bf16_grads_over_bar"] = misses
                errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
                controls = {}
                if pair != "future":
                    controls["kv_offset_plus_1"] = dict(at, kv_offset=ki * t + 1, q_ids=q_ids, k_ids=k_ids)
                if pair == "past" and docs:
                    controls["q_ids_as_k_ids"] = dict(at, q_ids=q_ids, k_ids=q_ids)
                for what, kw in controls.items():
                    off = flash.flash_grads_reference(*f32_in, **kw, delta=delta)
                    c_miss = [grad_miss(a, b) for a, b in zip(got, off)]
                    if max(c_miss) <= 1.0:
                        raise AssertionError(f"sp {label} {pair}: the {what} control passes the bars ({c_miss})")
                    line[f"grads_{what}_over_bar"] = c_miss
                    del off
            line.update(dq_max_err=errs[0], dk_max_err=errs[1], dv_max_err=errs[2])
            log(line)
            del ref
            if not (label in ("main", "main_docs") and pair == "past"):
                continue
            suffix = flash.DOCS if docs else ""
            check_deterministic(qs, ks, vs, dos, lse_g, delta,
                                dict(causal=True, alibi=True, scale=scale, q_offset=qi * t, kv_offset=ki * t,
                                     q_ids=q_ids, k_ids=k_ids, out_dtype=torch.float32), f"sp {label} {pair}")
            kern = {
                "flash_partial_fwd": lambda: flash.flash_partial(qs, ks, vs, **at, q_ids=q_ids, k_ids=k_ids),
                "flash_partial_dq": lambda: flash.launch_dq(
                    qs, ks, vs, dos, lse_g, delta, causal=True, alibi=True, scale=scale, q_offset=qi * t,
                    kv_offset=ki * t, q_ids=q_ids, k_ids=k_ids, out_dtype=torch.float32, counter="flash_partial_dq"),
                "flash_partial_dkv": lambda: flash.launch_dkv(
                    qs, ks, vs, dos, lse_g, delta, causal=True, alibi=True, scale=scale, q_offset=qi * t,
                    kv_offset=ki * t, q_ids=q_ids, k_ids=k_ids, out_dtype=torch.float32, counter="flash_partial_dkv"),
            }
            kern_ms = {n: time_ms(fn, iters=10) for n, fn in kern.items()}
            kern_dev = {n: device_ms(fn, iters=10) for n, fn in kern.items()}
            plain_fwd = time_ms(lambda: flash.flash_partial_reference(qs, ks, vs, **at, q_ids=q_ids, k_ids=k_ids),
                                iters=3)
            # the plain backward computes dq, dk and dv together: one time for K2 and K3
            plain_bwd = time_ms(lambda: flash.flash_grads_reference(qs, ks, vs, o_g, lse_g, dos, **at, delta=delta,
                                                                    q_ids=q_ids, k_ids=k_ids), iters=3)
            bias = sp_sdpa_bias(qi * t, ki * t, t, Hq, q_ids, k_ids, dtype)
            qt, kt, vt = (x.transpose(1, 2).requires_grad_() for x in (qs, ks, vs))
            lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), iters=10)
            lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dos.transpose(1, 2),
                                                          retain_graph=True), iters=10)
            pairs = t * t if qi > ki else causal_pairs(t, True)
            bounds = partial_bounds(B, t, Hq, KVH, Dq, dtype, pairs, 8 * B * t if docs else 0)
            for name in kern:
                err = line["fwd_max_err"] if name == "flash_partial_fwd" else (
                    errs[0] if name == "flash_partial_dq" else max(errs[1:]))
                bound, by = bounds[name]
                rows[name + suffix] = dict(max_abs_err=err, ms=kern_ms[name], device_ms=kern_dev[name],
                                           plain_ms=plain_fwd if name == "flash_partial_fwd" else plain_bwd,
                                           library_ms=lib_fwd if name == "flash_partial_fwd" else lib_bwd,
                                           bound_ms=bound, bound_by=by)
                log({"kernel": name + suffix, "shape": [B, t, Hq, KVH, Dq], "pair": pair, **rows[name + suffix]})
            del lib_out, qt, kt, vt, bias
        del q, k, v, do, o_all, lse_all
        torch.cuda.empty_cache()
    return rows


# -------------------------------------------------------- sequence parallel

SP_RANKS, SP_SEQ, SP_MODEL, SP_LR = 4, 8192, "580m", 1e-4
SP_SEPARATORS = (1000, 2047, 2048, 3000, 6100, 8191)  # packed case: across and on shard edges
SP_STEP_CASES = {"plain": {}, "packed": {"doc_sep_token": 0}}  # 580m overrides


def sp_layer_inputs(docs: bool):
    """580m's attention at T 8192 (one row, 12 heads of 128, bf16), made on
    the CPU from seed 21 so every rank and the one-card run see the same
    tensors: q, k, v, the output grad g, and document ids (or None)."""
    g = torch.Generator().manual_seed(21)
    q, k, v, do = (torch.randn(1, SP_SEQ, 12, 128, generator=g).bfloat16() for _ in range(4))
    return q, k, v, do, (sp_doc_ids(1, SP_SEQ).cpu() if docs else None)


def sp_batch(packed: bool) -> torch.Tensor:
    """One micro-batch [1, 1, T 8192] of token ids from seed 23 (the packed
    case with separators across and on the shard edges)."""
    tokens = torch.randint(1, 50304, (1, 1, SP_SEQ), generator=torch.Generator().manual_seed(23), dtype=torch.int32)
    if packed:
        tokens[..., list(SP_SEPARATORS)] = 0
    return tokens


def sp_model(overrides: dict, device, dtype=torch.bfloat16):
    from zero_transformer_tpu_torch.models import model_getter

    return model_getter(SP_MODEL, dtype=dtype, device=device, seed=SEED, trainable=True, dropout=0.0,
                        remat=True, **overrides)


def param_checksum(model) -> int:
    """The sum of every float32 param's bits read as int32: equal only if
    the params are (up to a collision) bit-equal."""
    return sum(int(p.detach().view(torch.int32).sum(dtype=torch.int64)) for p in model.parameters())


def _sp_rank(rank: int, world: int, backend: str, init_file: str, out_dir: str, dtype_name: str) -> None:
    """One rank of the sequence-parallel phase: the op-level ring at 580m's
    layer shape, then one ring train step of 580m per case (launch counts,
    grad cosines against the one-card grads on rank 0, the param checksum,
    peak memory), and a second step under the profiler on rank 0."""
    from torch.profiler import ProfilerActivity, profile

    from zero_transformer_tpu_torch.config import OptimizerConfig
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.ops.ring_attention import ring_attention
    from zero_transformer_tpu_torch.parallel.mesh import destroy, init_distributed
    from zero_transformer_tpu_torch.parallel.zero import TrainState, make_train_step
    from zero_transformer_tpu_torch.training.optimizer import make_optimizer, make_schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    out = Path(out_dir)
    group = init_distributed(world, backend, "cuda", rank=rank, world_size=world,
                             init_method=f"file://{init_file}", local_rank=rank)
    dev = group.device
    result = {"rank": rank, **group.describe()}
    t = SP_SEQ // world
    sl = slice(rank * t, (rank + 1) * t)
    for docs in (False, True):
        q, k, v, do, ids = sp_layer_inputs(docs)
        qs, ks, vs = (x[:, sl].to(dev).requires_grad_() for x in (q, k, v))
        o = ring_attention(qs, ks, vs, group, causal=True, alibi=True,
                           doc_ids=None if ids is None else ids[:, sl].to(dev))
        grads = torch.autograd.grad(o, (qs, ks, vs), do[:, sl].to(dev))
        torch.save([x.detach().cpu() for x in (o, *grads)], out / f"op_{int(docs)}_{rank}.pt")
        del q, k, v, do, qs, ks, vs, o, grads
    for case, overrides in SP_STEP_CASES.items():
        model = sp_model(overrides, dev, dtype).set_sequence_group(group)
        init_checksum = param_checksum(model)
        opt_cfg = OptimizerConfig(schedule="constant", peak_learning_rate=SP_LR)
        schedule = make_schedule(opt_cfg)
        st = TrainState(step=0, model=model, optimizer=make_optimizer(model, opt_cfg, schedule))
        captured, adamw_step = {}, st.optimizer.step

        def capture(grads, _step=adamw_step):  # the grads the step hands to AdamW
            captured["grads"] = grads
            return _step(grads)

        st.optimizer.step = capture
        step = make_train_step(1, schedule, seq_group=group)
        batch = sp_batch(case == "packed").to(dev)
        torch.cuda.synchronize(dev)
        group.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        metrics = step(st, batch)
        torch.cuda.synchronize(dev)
        step_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        line = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]), "step_s": step_s,
                "launches": {n: c for n, c in launches.items() if c}, "init_checksum": init_checksum,
                "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        if rank == 0:
            ref = torch.load(out / f"ref_{case}.pt", mmap=True, weights_only=True)
            names = [n for n, _ in model.named_parameters()]
            cos = {n: float(torch.nn.functional.cosine_similarity(
                g.flatten().double(), ref["grads"][n].to(dev).flatten().double(), dim=0))
                for n, g in zip(names, captured["grads"])}
            line.update(grad_cos_min=min(cos.values()), grad_cos_min_tensor=min(cos, key=cos.get),
                        grad_cos_below_bar={n: c for n, c in cos.items() if c < COS_BAR}, ref_loss=ref["loss"])
            del ref
        captured.clear()
        line["checksum_after_update"] = param_checksum(model)
        # a second step, under the profiler on rank 0: where the ring step's time goes
        group.barrier()
        if rank == 0:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(st, batch)
                torch.cuda.synchronize(dev)
                wall_ms = (time.perf_counter() - t0) * 1e3
            spans = {ev.key: ev.cpu_time_total / 1e3 for ev in prof.key_averages()
                     if ev.key.startswith("sequence_group.") and str(ev.device_type).endswith("CPU")}
            kernels = kernel_times(prof)
            busy = sum(ms for ms, _ in kernels.values())
            flash_ms = sum(ms for name, (ms, _) in kernels.items() if "flash" in name)
            line["profile"] = {
                "wall_ms": wall_ms, "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
                "flash_kernels_ms": flash_ms, "all_reduce_ms": spans.get("sequence_group.all_reduce", 0.0),
                "all_reduce_share": spans.get("sequence_group.all_reduce", 0.0) / wall_ms,
                "rotate_ms": spans.get("sequence_group.rotate", 0.0),
                "rotate_share": spans.get("sequence_group.rotate", 0.0) / wall_ms,
                "top_kernels_ms": top_kernels(kernels, 10, 1, 60)}
        else:
            step(st, batch)
            torch.cuda.synchronize(dev)
        result[case] = line
        del st, model, step, batch, metrics, capture, adamw_step
        gc.collect()  # the AdamW step wrapper made a cycle through the optimizer
        torch.cuda.empty_cache()
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    group.barrier()
    destroy(group)


def sequence_parallel_phase(dtype=torch.bfloat16) -> dict:
    """580m at T 8192 over 4 ranks: NCCL with a card per rank when the
    machine has 4, else 4 ranks sharing card 0 over gloo (each rank's
    kernels run on the card; the transfers stage through pinned host
    memory). Before the ranks start, the one-card reference: one 580m step's
    loss and grads (remat, the same seeded weights and batch) per case,
    saved for rank 0. Then the ranks run the ring at the layer shape and
    the ring train step (``_sp_rank``). Fails unless: the ring's output is
    within the bf16 bar (atol/rtol 2e-2) of the one-card ``flash_attention``
    on the gathered tensors and its grads within K2/K3's bar (one bf16 ulp +
    GRAD_ATOL of the largest |grad|), with and without document ids; the
    ring step's loss is within LOSS_MARGIN of the one-card loss, every
    grad's cosine at least COS_BAR; the seeded weights and the params after
    the update are bit-equal across the ranks (checksums); the launches per
    rank per micro-step are exact: flash_partial_fwd = L x n x 2 (the
    forward, and its recompute under remat), flash_partial_dq =
    flash_partial_dkv = L x n, for L layers and n ranks (the ``_docs``
    counters in the packed case). Then the trainer CLI under
    ``torch.distributed.run`` for 3 steps of configs/train_580m_8k.yaml,
    and the same CLI on one card. Returns the ring's launch counts and, as
    the ``_d128`` rows of the kernel table, the one-card reference's
    (the training entry at D 128: ``flash_train_fwd_d128``,
    ``flash_dq_d128``, ``flash_dkv_d128``, plain case).

    With ``dtype`` float32 (the ``sequence_parallel_f32`` phase) every
    kernel of both sides takes its f32 path: the same bars and readings
    under ``_f32`` names, without the trainer CLIs."""
    import torch.multiprocessing as mp

    from zero_transformer_tpu_torch.config import model_config
    from zero_transformer_tpu_torch.ops import _build, flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = "" if dtype == torch.bfloat16 else "_" + str(dtype).removeprefix("torch.")
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= SP_RANKS else "gloo"
    topology = {"ranks": SP_RANKS, "cards": min(cards, SP_RANKS), "backend": backend,
                "transfers": "NCCL, card to card" if backend == "nccl" else "gloo through pinned host memory"}
    log({f"sequence_parallel{tag}_topology": topology})
    out = Path("build") / "sp"
    out.mkdir(parents=True, exist_ok=True)
    L = model_config(SP_MODEL).n_layers

    # the one-card reference, before the ranks take the card's memory
    ref_loss, one_card_launches = {}, {}
    for case, overrides in SP_STEP_CASES.items():
        model = sp_model(overrides, "cuda", dtype)
        init_checksum = param_checksum(model)
        batch = sp_batch(case == "packed")[0].cuda()
        loss_and_grads(model, batch)  # warm-up: cuBLAS's and the allocator's first calls
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(model, batch)
        torch.cuda.synchronize()
        ref_loss[case] = (loss, init_checksum, time.perf_counter() - t0)
        one_card_launches[case] = {n: c for n, c in _build.LAUNCHES.items() if c}
        torch.save({"loss": loss, "grads": {n: g.cpu() for n, g in grads.items()}}, out / f"ref_{case}.pt")
        del model, grads, batch
        torch.cuda.empty_cache()
    log({f"sequence_parallel{tag}_one_card_reference": {
        c: {"loss": l, "step_s": s, "launches": one_card_launches[c]} for c, (l, _, s) in ref_loss.items()}})

    init_file = out / "rendezvous"
    if init_file.exists():
        init_file.unlink()
    t0 = time.perf_counter()
    ctx = mp.start_processes(_sp_rank, args=(SP_RANKS, backend, str(init_file.resolve()), str(out),
                                             str(dtype).removeprefix("torch.")),
                             nprocs=SP_RANKS, join=False, start_method="spawn")
    end = time.monotonic() + 900
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):  # one rank at a time
            if time.monotonic() >= end:
                raise AssertionError("the sequence-parallel ranks did not finish within 900 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    ranks_s = time.perf_counter() - t0
    results = [json.loads((out / f"rank{r}.json").read_text()) for r in range(SP_RANKS)]

    # the op-level ring against the one-card flash_attention on the gathered tensors
    op = {}
    for docs in (False, True):
        q, k, v, do, ids = sp_layer_inputs(docs)
        q, k, v = (x.cuda().requires_grad_() for x in (q, k, v))
        one = flash.flash_attention(q, k, v, causal=True, alibi=True, doc_ids=None if ids is None else ids.cuda())
        one_grads = torch.autograd.grad(one, (q, k, v), do.cuda())
        shards = [torch.load(out / f"op_{int(docs)}_{r}.pt") for r in range(SP_RANKS)]
        ring = [torch.cat([s[i] for s in shards], dim=1).cuda() for i in range(4)]
        line = {"out_max_err": compare(ring[0], one.detach(), torch.bfloat16, f"ring out docs={docs}")}
        misses = [grad_miss(a, b.float()) for a, b in zip(ring[1:], one_grads)]
        if max(misses) > 1.0:
            raise AssertionError(f"ring grads docs={docs}: {misses} of K2/K3's bars against the one-card grads")
        line["grads_over_bar"] = misses
        line["grads_max_err"] = [float((a.float() - b.float()).abs().max()) for a, b in zip(ring[1:], one_grads)]
        op["docs" if docs else "no_docs"] = line
        del q, k, v, one, one_grads, ring, shards
    torch.cuda.empty_cache()
    log({f"sequence_parallel{tag}_op": op})

    launches = {}
    for case in SP_STEP_CASES:
        lines = [r[case] for r in results]
        loss_ref, ref_init, _ = ref_loss[case]
        first = lines[0]
        summary = {"loss_ring": first["loss"], "loss_one_card": loss_ref, "loss_margin": LOSS_MARGIN,
                   "grad_cos_min": first["grad_cos_min"], "grad_cos_min_tensor": first["grad_cos_min_tensor"],
                   "step_s_per_rank": [x["step_s"] for x in lines],
                   "peak_memory_gib_per_rank": [x["peak_memory_gib"] for x in lines],
                   "checksums_after_update": [x["checksum_after_update"] for x in lines],
                   "launches_rank0": first["launches"], "profile_rank0": first["profile"]}
        log({f"sequence_parallel{tag}_step_{case}": summary})
        if not abs(first["loss"] - loss_ref) <= LOSS_MARGIN:
            raise AssertionError(f"{case}: ring loss {first['loss']} vs one-card {loss_ref}")
        if first["grad_cos_below_bar"]:
            raise AssertionError(f"{case}: grad cosines below {COS_BAR}: {first['grad_cos_below_bar']}")
        if any(x["init_checksum"] != ref_init for x in lines):
            raise AssertionError(f"{case}: the ranks' seeded weights differ from the one-card model's")
        if len({x["checksum_after_update"] for x in lines}) != 1:
            raise AssertionError(f"{case}: params differ across the ranks after the update")
        sfx = flash.DOCS if case == "packed" else ""
        want = {"flash_partial_fwd" + sfx: L * SP_RANKS * 2, "flash_partial_dq" + sfx: L * SP_RANKS,
                "flash_partial_dkv" + sfx: L * SP_RANKS}
        for x in lines:
            if x["launches"] != want:
                raise AssertionError(f"{case} rank launches {x['launches']}, want exactly {want}")
        launches.update(first["launches"])
    # the training entry at D 128: the one-card reference's launches
    launches.update({n + "_d128": one_card_launches["plain"].get(n, 0)
                     for n in ("flash_train_fwd", "flash_dq", "flash_dkv")})
    if dtype != torch.bfloat16:
        for f in out.glob("*.pt"):
            f.unlink()
        return launches

    # the trainer CLI under torch.distributed.run, then on one card
    sets = ["model.dropout=0.0", "training.gradient_accumulation_steps=1", "training.log_frequency=1"]
    flops = (f"tokens/s * 3 * (2 * N + 4 * L * d * T) / (989e12 * cards), "
             f"N = {model_config(SP_MODEL).num_params}, L = {L}, d = 1536, T = {SP_SEQ}")
    ring_cli, proc = trainer_cli_580m(
        ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(SP_RANKS), "-m",
         "zero_transformer_tpu_torch.train", "--dist-backend", backend], [f"mesh.sequence={SP_RANKS}", *sets],
        Path("chiprun_out") / "train_580m_8k_sp")
    topo = next((json.loads(line)["distributed"] for line in proc.stdout.splitlines()
                 if line.startswith('{"distributed"')), None)
    log({"sequence_parallel_trainer_cli": {**ring_cli, "ranks_phase_s": ranks_s, "topology": topo,
                                           "model_flops_formula": flops}})
    if topo is None or topo["backend"] != backend or ring_cli["model_flops_share"] is None:
        raise AssertionError(f"the trainer CLI printed no topology or no model-FLOPs share: {topo}, {ring_cli}")
    one_cli, _ = trainer_cli_580m(["-m", "zero_transformer_tpu_torch.train"], sets,
                                  Path("chiprun_out") / "train_580m_8k_one_card")
    log({"one_card_trainer_cli_580m": {**one_cli, "model_flops_formula": flops}})
    for f in out.glob("*.pt"):
        f.unlink()
    return launches


def trainer_cli_580m(launcher: list, sets: list, run_dir: Path):
    """3 steps of configs/train_580m_8k.yaml through the trainer CLI
    (``launcher`` the interpreter arguments before ``--cfg``); fails unless
    it exits 0 and logs 3 finite losses. Returns its last step's readings
    and the finished process."""
    import os

    if (run_dir / "metrics.jsonl").exists():
        (run_dir / "metrics.jsonl").unlink()
    cmd = [sys.executable, *launcher, "--cfg", "configs/train_580m_8k.yaml", "--max-steps", "3", "--set", *sets,
           f"checkpoint.directory={run_dir}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"trainer CLI exit {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "loss" in r]
    if len(train) != 3 or not all(math.isfinite(r["loss"]) for r in train):
        raise AssertionError(f"trainer CLI metrics incomplete or non-finite: {records}")
    last = train[-1]
    return {"wall_s": wall, "losses": [r["loss"] for r in train], "step_time_ms": last["step_time_ms"],
            "tokens_per_sec": last["tokens_per_sec"], "model_flops_share": last.get("model_flops_share")}, proc


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


PHASES = ("kernels", "serving", "parity", "profile", "int8_kernels", "int8_serving", "train_kernels", "training",
          "packed_kernels", "packed", "sp_kernels", "sequence_parallel")
# named with --phases only: the ring's parity with every kernel on its f32 path
EXTRA_PHASES = ("sequence_parallel_f32",)
SOURCES = {
    "flash_serving_fwd": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                          "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "paged_attention": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                        "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    # the same kernel's int8 branch (paged_attention.py:121-135)
    "paged_attention_int8": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                             "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    "flash_train_fwd": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                        "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_dq": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                 "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_dkv": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                  "zero_transformer_tpu/ops/pallas/flash.py:214"),
    # the same kernels' packed-document branch (flash.py:108-110, `_scores`)
    "flash_train_fwd_docs": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                             "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_dq_docs": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                      "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_dkv_docs": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                       "zero_transformer_tpu/ops/pallas/flash.py:214"),
    # the same kernels at global offsets with f32 outputs: flash_partial
    # (flash.py:551) and flash_grads (:577), with and without document ids
    "flash_partial_fwd": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                          "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_partial_dq": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                         "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_partial_dkv": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                          "zero_transformer_tpu/ops/pallas/flash.py:214"),
    "flash_partial_fwd_docs": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                               "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_partial_dq_docs": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                              "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_partial_dkv_docs": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                               "zero_transformer_tpu/ops/pallas/flash.py:214"),
    # the training entry at D 128: 580m's one-card step (B 1, T 8192)
    "flash_train_fwd_d128": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                             "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_dq_d128": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                      "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_dkv_d128": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                       "zero_transformer_tpu/ops/pallas/flash.py:214"),
}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only", file=sys.stderr)
        return 2
    phases = PHASES
    if argv[:1] == ["--phases"] and len(argv) == 2:
        phases = tuple(argv[1].split(","))
    elif argv:
        print(f"usage: chip_smoke.py [--phases {','.join(PHASES + EXTRA_PHASES)}]", file=sys.stderr)
        return 2
    if set(phases) - set(PHASES + EXTRA_PHASES):
        print(f"chip_smoke: unknown phases {sorted(set(phases) - set(PHASES + EXTRA_PHASES))}", file=sys.stderr)
        return 2
    from zero_transformer_tpu_torch.ops import _build

    log(card_line())
    t0 = time.perf_counter()
    fresh = _build.build_all()
    log({"build_s": time.perf_counter() - t0, "per_source_s": fresh})
    for name, report in _build.ptxas_report.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Performance" in line:
                log(f"ptxas {name}: {line.strip()}")
    rows, launches = {}, {}
    if "kernels" in phases:
        rows.update(kernel_phase())
    bf16_serving = None
    if "serving" in phases:
        serving_launches, kernel_tokens, bf16_serving = serving_phase()
        launches.update({k: serving_launches[k] for k in ("flash_serving_fwd", "paged_attention")})
        if "parity" in phases:
            parity_phase(kernel_tokens)
    if "profile" in phases:
        profile_phase()
    if "int8_kernels" in phases:
        rows.update(int8_kernel_phase())
    if "int8_serving" in phases:
        int8_launches, int8_tokens, int8_serving = serving_phase(int8=True)
        launches["paged_attention_int8"] = int8_launches["paged_attention_int8"]
        if bf16_serving is not None:
            keys = ("ttft_ms_p50", "ttft_ms_p99", "itl_ms_p50", "itl_ms_p99", "decode_tok_s", "kv_pool_bytes",
                    "weight_bytes")
            log({"int8_vs_bf16_serving": {k: [int8_serving[k], bf16_serving[k]] for k in keys}})
        parity_phase(int8_tokens, int8=True)
        profile_phase(int8=True)
    if "train_kernels" in phases:
        rows.update(train_kernel_phase())
    if "training" in phases:
        train_launches = training_phase()
        launches.update({k: train_launches[k] for k in ("flash_train_fwd", "flash_dq", "flash_dkv")})
    if "packed_kernels" in phases:
        rows.update(packed_kernel_phase())
    if "packed" in phases:
        packed_launches = packed_phase()
        launches.update({k: packed_launches[k] for k in ("flash_train_fwd_docs", "flash_dq_docs",
                                                         "flash_dkv_docs")})
    if "sp_kernels" in phases:
        rows.update(sp_kernel_phase())
    if "sequence_parallel" in phases:
        launches.update(sequence_parallel_phase())
    if "sequence_parallel_f32" in phases:
        sequence_parallel_phase(torch.float32)
    table = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu, "launches": launches[name],
         **rows[name]}
        for name, (src, tpu) in SOURCES.items() if name in rows and name in launches
    ]
    log({"kernels": table})
    if phases != PHASES:
        return 0
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
