"""The port's slab serving layout against JAX's ``ServingEngine`` with
``kv_layout="slab"``, on the ``test`` model (ALiBi), ``llama3_test`` (RoPE,
GQA, SwiGLU, RMSNorm), ``test`` with learned positions and ``test`` over an
int8 cache, in float32, same weights on both sides:

- the one-shot bucketed prefill (``prefill_chunk=0``): greedy streams over
  prompt lengths that cross buckets equal JAX's, and so do the counters;
  the last logits row of one prefill is within 1e-5 of JAX ``_prefill``;
  JAX's bucket sequence (``tests/test_serving_prefill.py``) replayed on
  both engines gives equal buckets, ``prefill_bucket_capped`` and
  ``prefill_buckets``; seeded sampled streams equal the paged engine's
  (the same generator draws; JAX's sampler draws from another generator);
- the chunked slab with the prefix cache (span copies): streams and the
  cache's hits, misses, stores and evictions equal JAX's, and the hits and
  misses equal the paged engine's on the same traffic;
- ``draft_k`` on the slab equals JAX's slab engine;
- ``fused_tail=False`` equals the fused tick (greedy and sampled) and
  JAX's control;
- ``metrics_snapshot`` keys, ``free_pages`` tick by tick, the refusals of
  migration, import and ``prefill_to``, and the constructor's validations
  equal JAX's;
- ``SlotKVCache``: slots, double release, exact span copies; a failed
  one-shot admission fails its handle and still installs the ones before.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_serving import WEIGHT_SCALE, make_pair
from zero_transformer_tpu.inference.sampling import SamplingConfig as JaxSampling
from zero_transformer_tpu.serving import ServingEngine as JaxEngine
from zero_transformer_tpu_torch.inference.generate import allocate_pools
from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
from zero_transformer_tpu_torch.serving import ServingEngine, SlotKVCache

torch.set_num_threads(1)

CACHE_LEN = 64
PAIRS = {
    "test": dict(name="test"),
    "llama3_test": dict(name="llama3_test"),
    "test_learned": dict(name="test", position="learned"),
    "test_int8_kv": dict(name="test", kv_cache_dtype="int8"),
}
SAMPLED = dict(temperature=0.8, top_p=0.9, repetition_penalty=1.1)


@functools.lru_cache(maxsize=None)
def _pair(name):
    return make_pair(seed=0, scale=WEIGHT_SCALE, **PAIRS[name])


@pytest.fixture(scope="module", params=sorted(PAIRS))
def pair(request):
    return request.param, _pair(request.param)


@pytest.fixture(scope="module")
def test_pair():
    return make_pair(seed=0, scale=WEIGHT_SCALE)


def port(model, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("sampling", SamplingConfig(greedy=True))
    kw.setdefault("kv_layout", "slab")
    kw.setdefault("prefill_chunk", 0)
    return ServingEngine(model, device="cpu", **kw)


def jaxe(jcfg, params, sampling=None, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("kv_layout", "slab")
    kw.setdefault("prefill_chunk", 0)
    return JaxEngine(jcfg, params, sampling=sampling or JaxSampling(greedy=True), **kw)


def prompts_for(name, lengths=(3, 8, 9, 16, 17, 31, 5)):
    if name == "test_learned":  # learned positions stop at max_seq_len 32
        lengths = tuple(min(n, 24) for n in lengths)
    return [[(7 * i + 3 * j) % 250 + 1 for j in range(n)] for i, n in enumerate(lengths)]


def run(engine, prompts, max_new=8, seeds=None):
    handles = [engine.submit(p, max_new_tokens=max_new, seed=seeds[i] if seeds else i) for i, p in enumerate(prompts)]
    engine.run_until_idle()
    return handles


def streams(handles):
    return [(h.status, list(h.tokens)) for h in handles]


STAT_KEYS = ("submitted", "completed", "tokens_out", "prefill_chunks", "prefill_bucket_capped", "peak_occupancy")


def test_oneshot_streams_and_counters_match_jax(pair):
    name, (jcfg, params, model) = pair
    prompts = prompts_for(name)
    teng, jeng = port(model), jaxe(jcfg, params)
    th, jh = run(teng, prompts), run(jeng, prompts)
    assert streams(th) == streams(jh)
    assert all(s == "done" for s, _ in streams(th))
    assert {k: teng.stats[k] for k in STAT_KEYS} == {k: jeng.stats[k] for k in STAT_KEYS}
    assert teng.metrics_snapshot()["prefill_buckets"] == jeng.metrics_snapshot()["prefill_buckets"]
    assert teng.stats["prefill_ticks"] == 0  # no chunk ticks on the one-shot path


@pytest.mark.parametrize("length", [5, 9, 17, 31])
def test_oneshot_last_logits_match_jax_prefill(pair, length):
    name, (jcfg, params, model) = pair
    prompt = prompts_for(name, (length,))[0]
    teng, jeng = port(model), jaxe(jcfg, params)
    with torch.no_grad():
        got = teng._prefill_oneshot(teng.slots.acquire(), prompt).numpy()
    want = np.asarray(jax.device_get(jeng._prefill(prompt)[0]))[0]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert teng._buckets_seen == jeng._buckets_seen


@pytest.mark.parametrize("cap_name", ["test", "test_learned"])
def test_bucket_sequence_matches_jax(cap_name):
    jcfg, params, model = make_pair(seed=0, scale=WEIGHT_SCALE, **PAIRS[cap_name])
    teng, jeng = port(model, n_slots=1, max_prefill_buckets=2), jaxe(jcfg, params, n_slots=1, max_prefill_buckets=2)
    lengths = (3, 12, 24, 5, 13, 9, 40, 2) if cap_name == "test" else (3, 12, 24, 5, 13, 9, 30, 2)
    got = [teng._bucket(n) for n in lengths]
    assert got == [jeng._bucket(n) for n in lengths]
    cap = CACHE_LEN if cap_name == "test" else 32
    assert got[:6] == [8, 16, cap, 8, 16, 16]  # JAX's own test's sequence
    assert teng.stats["prefill_bucket_capped"] == jeng.stats["prefill_bucket_capped"] >= 1
    assert teng.metrics_snapshot()["prefill_buckets"] == jeng.metrics_snapshot()["prefill_buckets"] == 3
    prompt = prompts_for(cap_name, (24,))[0]
    assert streams(run(teng, [prompt], max_new=4, seeds=[7])) == streams(run(jeng, [prompt], max_new=4, seeds=[7]))


def test_oneshot_sampled_equals_paged_and_is_reproducible(test_pair):
    _, _, model = test_pair
    prompts = prompts_for("test")
    sampling = SamplingConfig(**SAMPLED)
    seeds = [11 * i + 3 for i in range(len(prompts))]
    slab = streams(run(port(model, sampling=sampling), prompts, seeds=seeds))
    assert slab == streams(run(port(model, sampling=sampling), prompts, seeds=seeds))
    paged = port(model, sampling=sampling, kv_layout="paged", prefill_chunk=16, page_size=8)
    assert slab == streams(run(paged, prompts, seeds=seeds))
    assert len({tuple(t) for _, t in slab}) > 1


def _prefix_traffic():
    shared = [(5 * j) % 200 + 3 for j in range(24)]
    return [shared + [(11 * i + j) % 200 + 1 for j in range(3 + 2 * i)] for i in range(4)]


def _run_prefix(engine, prompts):
    """The first prompt alone until its prefix is banked, then the rest."""
    first = engine.submit(prompts[0], max_new_tokens=6)
    engine.run_until_idle()
    rest = [engine.submit(p, max_new_tokens=6, seed=i + 1) for i, p in enumerate(prompts[1:])]
    engine.run_until_idle()
    return [first] + rest


PREFIX_KEYS = ("prefix_hits", "prefix_misses", "prefix_stores", "prefix_evictions", "prefix_entries")


@pytest.mark.parametrize("capacity", [16, 2])
@pytest.mark.parametrize("name", ["test", "llama3_test", "test_int8_kv"])
def test_slab_chunked_prefix_cache_matches_jax_and_paged(name, capacity):
    jcfg, params, model = _pair(name)
    prompts = _prefix_traffic()
    kw = dict(prefill_chunk=8, prefix_cache_chunks=capacity)
    teng, jeng = port(model, **kw), jaxe(jcfg, params, **kw)
    th, jh = _run_prefix(teng, prompts), _run_prefix(jeng, prompts)
    assert streams(th) == streams(jh)
    tsnap, jsnap = teng.metrics_snapshot(), jeng.metrics_snapshot()
    assert {k: tsnap[k] for k in PREFIX_KEYS} == {k: jsnap[k] for k in PREFIX_KEYS}
    assert teng.stats["prefill_chunks"] == jeng.stats["prefill_chunks"]
    assert [h.prefix_hit_tokens for h in th] == [h.prefix_hit_tokens for h in jh]
    paged = port(model, kv_layout="paged", page_size=8, **kw)
    ph = _run_prefix(paged, prompts)
    psnap = paged.metrics_snapshot()
    assert {k: psnap[k] for k in ("prefix_hits", "prefix_misses")} == {k: tsnap[k] for k in ("prefix_hits",
                                                                                              "prefix_misses")}
    assert streams(ph) == streams(th)
    # the copies serve the very K/V a cold engine computes
    assert streams(th) == streams(_run_prefix(port(model, prefill_chunk=8), prompts))
    if capacity == 16:
        assert tsnap["prefix_hits"] == 9  # three followers x the shared prefix's three chunks


@pytest.mark.parametrize("chunk", [0, 8])
def test_slab_draft_k_matches_jax(chunk):
    jcfg, params, model = make_pair(seed=0, scale=1.0)  # JAX's init: repetitive rows, drafts accepted
    prompts = [[3, 4, 5, 3, 4, 5, 3, 4, 5][: 4 + i] + [7] for i in range(4)]
    teng = port(model, draft_k=2, prefill_chunk=chunk)
    jeng = jaxe(jcfg, params, draft_k=2, prefill_chunk=chunk)
    assert streams(run(teng, prompts, max_new=10)) == streams(run(jeng, prompts, max_new=10))
    for key in ("spec_ticks", "draft_tokens", "accepted_tokens", "tokens_out"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["accepted_tokens"] > 0


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_defused_tick_equals_fused_and_jax(test_pair, layout):
    jcfg, params, model = test_pair
    prompts = prompts_for("test")
    kw = dict(prefill_chunk=0) if layout == "slab" else dict(kv_layout="paged", prefill_chunk=16, page_size=8)
    fused = streams(run(port(model, **kw), prompts))
    defused_eng = port(model, fused_tail=False, **kw)
    assert streams(run(defused_eng, prompts)) == fused
    assert defused_eng.metrics_snapshot()["fused_tail"] == 0
    jeng = jaxe(jcfg, params, fused_tail=False, **kw)
    assert streams(run(jeng, prompts)) == fused and jeng.metrics_snapshot()["fused_tail"] == 0
    sampling = SamplingConfig(**SAMPLED)
    seeds = [5, 6, 7, 8, 9, 10, 11]
    assert streams(run(port(model, fused_tail=False, sampling=sampling, **kw), prompts, seeds=seeds)) == \
        streams(run(port(model, sampling=sampling, **kw), prompts, seeds=seeds))


SNAP_KEYS = ("kv_layout", "fused_tail", "prefill_buckets", "prefill_bucket_capped", "free_pages", "page_pool_util",
             "page_pool_peak", "cow_copies", "prefill_chunk", "draft_k", "slot_occupancy", "prefilling")


@pytest.mark.parametrize("chunk", [0, 8])
def test_metrics_snapshot_and_free_pages_match_jax(test_pair, chunk):
    jcfg, params, model = test_pair
    prompts = prompts_for("test")
    kw = dict(prefill_chunk=chunk, max_prefill_buckets=2)
    engines = (port(model, n_slots=3, **kw), jaxe(jcfg, params, n_slots=3, **kw))
    for e in engines:
        for i, p in enumerate(prompts):
            e.submit(p, max_new_tokens=6, seed=i)
    trace = [[], []]
    for _ in range(200):
        busy = [e.step() for e in engines]
        for k, e in enumerate(engines):
            snap = e.metrics_snapshot()
            trace[k].append({key: snap[key] for key in SNAP_KEYS})
        if not any(busy):
            break
    assert trace[0] == trace[1]
    assert trace[0][-1]["kv_layout"] == "slab" and trace[0][-1]["free_pages"] == 3
    assert min(t["free_pages"] for t in trace[0]) == 0


def test_slab_refuses_migration_import_and_prefill_to(test_pair):
    jcfg, params, model = test_pair
    prompt = prompts_for("test", (12,))[0]
    out = []
    for e in (port(model, prefill_chunk=8), jaxe(jcfg, params, prefill_chunk=8)):
        h = e.submit(prompt, max_new_tokens=6, request_id="live-1")
        e.step()
        e.step()
        imported = e.import_stream({"kind": "decode", "prompt": [1, 2], "max_new_tokens": 2, "page_size": 16,
                                    "n_blocks": 1, "leaves": {"carry/last_logits": 0, "carry/gen_mask": 0,
                                                              "carry/rng": 0}, "request_id": "in-1"})
        shipped = e.submit(prompt, max_new_tokens=4, prefill_to="http://127.0.0.1:9")
        out.append((e.request_migration("live-1", "http://127.0.0.1:9"), e.request_migrate_all("http://x"),
                    imported.status, imported.error, shipped.status, shipped.error))
        e.run_until_idle()
        assert h.status == "done"
    assert out[0] == out[1]
    assert out[0][:3] == (False, 0, "rejected") and out[0][3] == "import requires kv_layout='paged'"


@pytest.mark.parametrize("kw", [dict(kv_layout="paged", prefill_chunk=0), dict(prefill_chunk=0, prefix_cache_chunks=4),
                                dict(max_prefill_buckets=0), dict(fused_tail=False, draft_k=2),
                                dict(kv_layout="ring"), dict(role="decode"), dict(prefill_chunk=-1)],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_constructor_validation_matches_jax(test_pair, kw):
    jcfg, params, model = test_pair
    with pytest.raises(ValueError):
        jaxe(jcfg, params, **kw)
    with pytest.raises(ValueError):
        port(model, **kw)


def test_slot_kv_cache_slots_and_exact_span_copies():
    from zero_transformer_tpu_torch.config import model_config

    slots = SlotKVCache(3, 40, 16)
    assert (slots.n_blocks, slots.n_pages, slots.free_count) == (3, 10, 3)
    assert slots.table.tolist() == [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    assert [slots.acquire() for _ in range(4)] == [0, 1, 2, None]
    slots.release([1])
    with pytest.raises(ValueError, match="double-released"):
        slots.release([1])
    assert (slots.active_count, slots.page_pool_util) == (2, 0.0)
    for kv in ("auto", "int8"):
        cfg = model_config("test", kv_cache_dtype=kv, compute_dtype="float32")
        pools = allocate_pools(cfg, slots.n_pages, 16, "cpu")
        gen = torch.Generator().manual_seed(0)
        for p in pools:
            for t in (p.k, p.v, p.k_scale, p.v_scale):
                if t is not None:
                    t.copy_(torch.randint(-100, 100, t.shape, generator=gen).to(t.dtype))
        spans = slots.extract_spans(0, 8, 3, pools)
        assert len(spans) == 3 and set(spans[0]) == ({"k", "v"} if kv == "auto" else {"k", "v", "k_scale", "v_scale"})
        assert tuple(spans[0]["k"].shape) == (cfg.n_layers, 8, cfg.kv_heads, cfg.head_width)
        before = [slots.row(p.k, 0)[:24].clone() for p in pools]
        slots.write_spans(spans[:2], 2, pools)
        for i, p in enumerate(pools):
            for field in spans[0]:
                row0, row2 = slots.row(getattr(p, field), 0), slots.row(getattr(p, field), 2)
                assert torch.equal(row2[:16], row0[:16])
            assert torch.equal(slots.row(p.k, 0)[:24], before[i])


def test_failed_oneshot_admission_fails_its_handle_and_installs_the_rest(test_pair):
    _, _, model = test_pair
    eng = port(model, n_slots=3)
    prompts = prompts_for("test", (9, 12, 5))
    calls = {"n": 0}
    real = eng._prefill_oneshot

    def flaky(slot, prompt):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected prefill failure")
        return real(slot, prompt)

    eng._prefill_oneshot = flaky
    handles = [eng.submit(p, max_new_tokens=4) for p in prompts]
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    assert handles[1].status == "failed" and "admission failed" in handles[1].error
    assert handles[0].status == "running" and eng.slots.free_count == 2
    eng._prefill_oneshot = real
    eng.run_until_idle()
    ref = port(model, n_slots=1)
    assert [h.tokens for h in (handles[0], handles[2])] == [h.tokens for h in run(ref, [prompts[0], prompts[2]],
                                                                                  max_new=4, seeds=[0, 0])]
