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
   device busy time per tick against the ticks' wall time.

The last two lines of standard output are the kernel table as one JSON
object and ``{"ok": true, "device": {...}}``. Without CUDA the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

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


def flash_mma_emulation(q, k, v, offsets, seg):
    """The bf16 tensor-core kernel's arithmetic, step by step: scores from
    the bf16 inputs (exact products, summed in float64, then float32), the
    biases in the kernel's order, an online softmax over its 64-key tiles
    with m and l in float32 from the unrounded P, P rounded to bf16 before
    the P.V product (exact products summed in float64), and the output
    rounded to bf16 once. A tile past a row's causal limit, which the kernel
    skips, adds exp(-1e10 - m) = 0 here, so every tile is visited.
    Returns ``(out [B, T, H, D] bf16, lse [B, H, T] f32)``."""
    from zero_transformer_tpu_torch.ops.flash import row_offsets, slopes_on
    from zero_transformer_tpu_torch.ops.positions import NEG_INF

    B, T, Hq, Dq = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = Hq // KVH
    kd = k.double().repeat_interleave(G, dim=2).transpose(1, 2)  # [B, H, S, D]
    vd = v.double().repeat_interleave(G, dim=2).transpose(1, 2)
    s = (q.double().transpose(1, 2) @ kd.transpose(-1, -2)).float()  # [B, H, T, S]
    offs = row_offsets(offsets, B, q.device)
    dist = offs[:, None, None] + torch.arange(T, device=q.device)[:, None] - torch.arange(S, device=q.device)
    bias = 0.0 - slopes_on(Hq, str(q.device), True)[None, :, None, None] * dist.clamp(min=0)[:, None].float()
    bias = bias + torch.where(dist >= 0, 0.0, NEG_INF)[:, None]
    x = s * (1.0 / Dq**0.5) + bias
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
    out = (o.float() / l_safe).bfloat16().transpose(1, 2)
    return out, (m + torch.log(l_safe))[..., 0]


def mma_miss(got: torch.Tensor, emu: torch.Tensor):
    """How far ``got`` is from the emulation: the largest |got - emu| over
    its bar (one bf16 ulp of emu plus MMA_ATOL) and the share of outputs
    that differ at all."""
    err = (got.float() - emu.float()).abs()
    over = float((err / (bf16_ulp(emu) + MMA_ATOL)).max())
    return over, float((err > 0).float().mean())


def check_mma(got, lse, q, k, v, offs, seg, label, shifted):
    """Hold the bf16 tensor-core kernel to its own rounding against
    ``flash_mma_emulation``: every output within one bf16 ulp plus MMA_ATOL,
    at most MMA_DIFFER_SHARE of the outputs different at all, lse within
    MMA_LSE_ATOL. With ``shifted``, also show that the check catches a kernel
    whose causal limit or validity mask is one key off: the emulation with
    every offset one later (one more key visible per row) and with every
    row's last valid key masked must each fail those bars."""
    emu, emu_lse = flash_mma_emulation(q, k, v, offs, seg)
    over, share = mma_miss(got, emu)
    lse_err = float((lse - emu_lse).abs().max())
    if not (over <= 1.0 and share <= MMA_DIFFER_SHARE and lse_err <= MMA_LSE_ATOL):
        raise AssertionError(f"flash {label} vs the mma emulation: max err {over} of its bar, "
                             f"{share} of outputs differ (bar {MMA_DIFFER_SHARE}), lse {lse_err} "
                             f"(bar {MMA_LSE_ATOL})")
    out = {"max_err_over_bar": over, "differ_share": share, "lse_max_abs_err": lse_err}
    if shifted:
        last = seg.int().cumsum(1) == seg.int().sum(1, keepdim=True)
        fewer = seg.bool() & ~(last & seg.bool())  # each row's last valid key masked
        for what, (o2, s2) in {"causal_limit_plus_1": (offs + 1, seg),
                               "validity_minus_1": (offs, fewer.int())}.items():
            s_over, s_share = mma_miss(got, flash_mma_emulation(q, k, v, o2, s2)[0])
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
            rows["flash_serving_fwd"] = dict(max_abs_err=err, ms=kern, plain_ms=plain,
                                             library_ms=lib, bound_ms=bound, bound_by=by)
            log({"kernel": "flash_serving_fwd", "max_err": err, "kernel_ms": kern,
                 "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": lib})

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
            rows["paged_attention"] = dict(max_abs_err=err, ms=kern, plain_ms=plain,
                                           library_ms=lib, bound_ms=bound, bound_by=by)
            log({"kernel": "paged_attention", "max_err": err, "kernel_ms": kern,
                 "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": lib})
    return rows


# ------------------------------------------------------------------ serving

PROMPT_LENS = (5, 63, 64, 65, 300, 900)
MAX_NEW = 32
SEED = 0


def prompt_text(n: int, salt: int) -> str:
    """``n`` printable non-space bytes (one byte-tokenizer token each)."""
    alphabet = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    return "".join(alphabet[(7 * i + 3 * salt + i // 11) % len(alphabet)] for i in range(n))


def build_engine(impl: str, dtype=torch.bfloat16):
    from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
    from zero_transformer_tpu_torch.models import model_getter
    from zero_transformer_tpu_torch.serving import ServingEngine

    model = model_getter("125m", dtype=dtype, device="cuda", seed=SEED,
                         attention_impl=impl)
    return ServingEngine(model, n_slots=SLOTS, cache_len=CACHE, sampling=SamplingConfig(greedy=True),
                         prefill_chunk=CHUNK, page_size=PAGE, device="cuda")


def http(method: str, url: str, body=None, timeout: float = 300.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def serving_phase():
    """125m behind the port's HTTP server; concurrent greedy requests."""
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.serve import ByteTokenizer
    from zero_transformer_tpu_torch.serving import ServingServer

    engine = build_engine("auto")
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
    if not all(launches[k] > 0 for k in launches):
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")
    summary = {
        "serving": {
            "requests": len(PROMPT_LENS), "prompt_lens": PROMPT_LENS, "max_new_tokens": MAX_NEW,
            "wall_s": wall, "tokens_out": metrics["tokens_out"],
            "ttft_ms_p50": metrics["ttft_ms_p50"], "ttft_ms_p99": metrics["ttft_ms_p99"],
            "itl_ms_p50": metrics["itl_ms_p50"], "itl_ms_p99": metrics["itl_ms_p99"],
            "decode_tok_s": metrics["decode_tok_s"], "decode_ticks": metrics["decode_ticks"],
            "prefill_ticks": metrics["prefill_ticks"],
            "paged_launches_per_decode_tick": launches["paged_attention"] / metrics["decode_ticks"],
            "flash_launches_per_prefill_tick": launches["flash_serving_fwd"] / metrics["prefill_ticks"],
            "launches": launches,
        }
    }
    log(summary)
    return launches, [r[2] for r in results]


def profile_phase(ticks: int = 20):
    """Where a decode tick's time goes: four 300-token streams prefilled,
    then ``ticks`` decode ticks under ``torch.profiler``. Device busy time is
    the sum of the CUDA kernels' self time; its share of the ticks' wall time
    says how far the host holds the card back. (The host clock around the
    profiled ticks includes the profiler's own overhead; the untraced tick
    time is the serving phase's ITL.)"""
    from torch.profiler import ProfilerActivity, profile

    engine = build_engine("auto")
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
    kernels = {}
    for ev in prof.key_averages():
        # kernel events only: CPU ops also carry the device time of what
        # they launched, and counting both would double it
        if str(ev.device_type).endswith("CUDA"):
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            kernels[ev.key] = (dev_us / 1e3, ev.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    log({"profile": {
        "decode_ticks": ticks, "slots": SLOTS, "wall_ms_per_tick": wall_ms / ticks,
        "device_busy_ms_per_tick": busy_ms / ticks if kernels else "not measured",
        "device_busy_share": busy_ms / wall_ms if kernels else "not measured",
        "device_launches_per_tick": sum(c for _, c in kernels.values()) / ticks,
        "top_kernels_ms_per_tick": {k[:60]: ms / ticks for k, (ms, _) in top},
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


def parity_phase(kernel_tokens):
    """The kernels against the plain path (``attention_impl="xla"``): logits
    of a prefill (last position) and four decode steps at the serving
    shapes, every run fed the same tokens, then greedy token agreement of a
    whole plain-path engine run with the serving phase.

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
    ref, forced = forced_logits(build_engine("xla", torch.float32), prompts, table)
    f32_k, _ = forced_logits(build_engine("auto", torch.float32), prompts, table, forced)
    f32_err = max(compare(k, r, torch.float32, f"float32 logits, step {i}")
                  for i, (k, r) in enumerate(zip(f32_k, ref)))
    bf_x, _ = forced_logits(build_engine("xla"), prompts, table, forced)
    bf_k, _ = forced_logits(build_engine("auto"), prompts, table, forced)
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
    eng_x = build_engine("xla")
    handles = [eng_x.submit(list(prompt_text(n, i).encode()), max_new_tokens=MAX_NEW, seed=i)
               for i, n in enumerate(PROMPT_LENS)]
    eng_x.run_until_idle()
    same = sum(int(a == b) for h, ref_toks in zip(handles, kernel_tokens) for a, b in zip(h.tokens, ref_toks))
    prefix = [next((j for j, (a, b) in enumerate(zip(h.tokens, ref_toks)) if a != b), len(ref_toks))
              for h, ref_toks in zip(handles, kernel_tokens)]
    log({"parity": {
        "float32_logits_max_abs_err": f32_err, "float32_tol": TOL[torch.float32],
        "bf16_logits_max_abs_err": worst, "logit_range": float(ref[0].abs().max()),
        "bf16_per_step_kernel_plain_vs_f32": steps,
        "bf16_argmax_agree": f"{agree}/{len(lens) * len(bf_k)}",
        "engine_tokens_agree": f"{same}/{MAX_NEW * len(PROMPT_LENS)}",
        "engine_identical_prefix": prefix,
    }})


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only", file=sys.stderr)
        return 2
    from zero_transformer_tpu_torch.ops import _build

    log(card_line())
    t0 = time.perf_counter()
    fresh = _build.build_all()
    log({"build_s": time.perf_counter() - t0, "per_source_s": fresh})
    for name, report in _build.ptxas_report.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    rows = kernel_phase()
    launches, kernel_tokens = serving_phase()
    parity_phase(kernel_tokens)
    profile_phase()
    sources = {
        "flash_serving_fwd": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                              "zero_transformer_tpu/ops/pallas/flash.py:127"),
        "paged_attention": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                            "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    }
    table = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu, "launches": launches[name],
         **rows[name]}
        for name, (src, tpu) in sources.items()
    ]
    log({"kernels": table})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
