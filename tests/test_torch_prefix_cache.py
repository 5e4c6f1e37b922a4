"""The port's prefix cache against the JAX package. CPU, float32, greedy.

- ``PrefixCache`` and ``PagedPrefixIndex`` (the port's copies) run the same
  hypothesis-generated operation sequences as JAX's, the paged index over
  each side's own ``PagePool``: every return value, ``stats()`` and every
  page refcount must be equal.
- The port's engine and the JAX ``ServingEngine`` (``kv_layout="paged"``,
  ``prefix_cache_chunks`` > 0) serve the same shared-prefix submissions:
  token-identical streams (each greedy step with a top-2 gap of at least
  1e-4), equal prefix hits / misses / stores / evictions, and equal
  ``page_faults`` / ``pages_reclaimed`` under a pool too small for the
  burst.
- The engine-level cases of JAX's ``tests/test_serving_paged.py`` for the
  index: a hit is a refcount bump, release never frees index-held pages,
  reclaim is refcount-aware, admission waits on an exhausted pool; and the
  copy-on-write guard copies a shared page's rows (scales included).
"""
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_serving import CHUNK, PAGE, assert_gaps, jax_engine, make_pair, port_engine
from zero_transformer_tpu.serving.prefix_cache import PagedPrefixIndex as JaxIndex
from zero_transformer_tpu.serving.prefix_cache import PrefixCache as JaxCache
from zero_transformer_tpu.serving.slots import PagePool as JaxPool
from zero_transformer_tpu_torch.models import model_getter
from zero_transformer_tpu_torch.serving.prefix_cache import PagedPrefixIndex, PrefixCache
from zero_transformer_tpu_torch.serving.slots import PagedKVCache, PagePool

MAX_NEW = 6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=0)


def _prompt(n: int, offset: int = 0):
    return [(offset + 7 * i) % 250 + 1 for i in range(n)]


# ------------------------------------------------------ the index, vs JAX

# prompts over a 3-token alphabet, chunk 2: shared prefixes are common
PROMPTS = st.lists(st.integers(1, 3), min_size=1, max_size=9)
CACHE_OPS = st.lists(st.one_of(
    st.tuples(st.just("store"), PROMPTS, st.integers(1, 4)),
    st.tuples(st.just("lookup"), PROMPTS),
    st.tuples(st.just("walk"), PROMPTS),
    st.tuples(st.just("contains"), PROMPTS, st.integers(1, 4)),
    st.tuples(st.just("flush")),
), max_size=40)


@settings(max_examples=150, deadline=None)
@given(capacity=st.integers(1, 5), ops=CACHE_OPS)
def test_prefix_cache_matches_jax(capacity, ops):
    port, ref = PrefixCache(2, capacity), JaxCache(2, capacity)
    for op in ops:
        kind, args = op[0], op[1:]
        if kind == "store":
            prompt, j = args
            if j * 2 > len(prompt):
                continue
            out = [c.store(prompt, j, (tuple(prompt[:j * 2]), j)) for c in (port, ref)]
        elif kind == "flush":
            out = [port.flush(), ref.flush()]
        else:
            out = [getattr(c, kind)(*args) for c in (port, ref)]
        assert out[0] == out[1], op
        assert port.stats() == ref.stats() and len(port) == len(ref)
        assert list(port._entries) == list(ref._entries) and port._children == ref._children


PAGED_OPS = st.lists(st.one_of(
    st.tuples(st.just("bank"), PROMPTS, st.integers(1, 4), st.booleans()),
    st.tuples(st.just("lookup"), PROMPTS),
    st.tuples(st.just("walk"), PROMPTS),
    st.tuples(st.just("reclaim"), st.integers(1, 6)),
    st.tuples(st.just("release"),),
    st.tuples(st.just("flush"),),
), max_size=40)


@settings(max_examples=150, deadline=None)
@given(capacity=st.integers(1, 5), ops=PAGED_OPS)
def test_paged_index_matches_jax(capacity, ops):
    """Banking allocates a chunk's 2 pages (page 1 token each), optionally
    keeps a slot's reference on them (``held``), and stores them; ``release``
    drops every slot reference; reclaim and flush go through each side's
    pool. Return values, stats and refcounts must agree."""
    pools = (PagePool(40), JaxPool(40))
    idx = (PagedPrefixIndex(2, capacity, pools[0]), JaxIndex(2, capacity, pools[1]))
    held = ([], [])
    for op in ops:
        kind, args = op[0], op[1:]
        out = []
        for side in (0, 1):
            pool, index = pools[side], idx[side]
            if kind == "bank":
                prompt, j, hold = args
                if j * 2 > len(prompt) or pool.free_count < 2:
                    out.append(None)
                    continue
                pages = [pool.alloc(), pool.alloc()]
                if hold:  # a slot keeps its own reference, as after bank()
                    pool.incref(pages)
                    held[side].append(pages)
                index.store_pages(prompt, j, pages)
                out.append(pages)
            elif kind == "release":
                out.append(sum(pool.decref(p) for p in held[side]))
                held[side].clear()
            elif kind == "reclaim":
                out.append(index.reclaim(args[0]))
            elif kind == "flush":
                out.append(index.flush())
            else:
                out.append(getattr(index, kind)(*args))
        assert out[0] == out[1], op
        assert idx[0].stats() == idx[1].stats()
        assert pools[0].refs == pools[1].refs and pools[0].free_count == pools[1].free_count


def test_prefix_lru_evicts_leaves_before_parents():
    """After a lookup touches chunks 1..k in order, eviction must take the
    least-recent LEAF, never orphan the deeper chain (JAX's case)."""
    pc = PrefixCache(chunk_tokens=4, capacity=3)
    p1 = list(range(1, 14))
    for j, v in ((1, "c1"), (2, "c2"), (3, "c3")):
        pc.store(p1, j, v)
    assert pc.lookup(p1)[0] == 12
    pc.store([99] + p1[1:], 1, "x1")
    assert pc.evictions == 1
    assert pc.lookup(p1) == (8, ["c1", "c2"])


def test_page_pool_unit():
    pool = PagePool(5)
    a, b = pool.alloc(), pool.alloc()
    assert pool.in_use == 2
    pool.incref([a])
    assert pool.decref([a]) == 0 and pool.decref([a]) == 1
    with pytest.raises(ValueError):
        pool.decref([a])
    with pytest.raises(ValueError):
        pool.incref([a])  # a free page cannot gain a holder
    pool.reserved = 2
    assert pool.available == pool.free_count - 2
    assert pool.decref([b]) == 1


# ------------------------------------------------- the engine, vs JAX's

SYSTEM = _prompt(40, offset=5)  # two whole chunks shared, the third not
SUFFIXES = [_prompt(n, offset=60 + 11 * n) for n in (3, 7, 12, 16)]


def _serve(engine, first, rest, max_new=MAX_NEW):
    """Submit ``first`` and run until it is done (its prefix banked), then
    the ``rest`` together."""
    handles = [engine.submit(first, max_new_tokens=max_new)]
    engine.run_until_idle()
    handles += [engine.submit(p, max_new_tokens=max_new) for p in rest]
    engine.run_until_idle()
    return handles


PREFIX_KEYS = ("prefix_hits", "prefix_misses", "prefix_stores", "prefix_evictions", "prefix_entries",
               "page_faults", "pages_reclaimed", "completed", "tokens_out", "prefill_chunks", "preemptions")


@pytest.mark.parametrize("capacity", [64, 2], ids=["roomy", "evicting"])
def test_shared_prefix_streams_and_stats_match_jax(pair, capacity):
    jcfg, params, model = pair
    prompts = [SYSTEM + s for s in SUFFIXES] + [_prompt(36, offset=200)]
    jeng = jax_engine(jcfg, params, prefix_cache_chunks=capacity)
    teng = port_engine(model, prefix_cache_chunks=capacity)
    jh = _serve(jeng, prompts[0], prompts[1:])
    th = _serve(teng, prompts[0], prompts[1:])
    for p, a, b in zip(prompts, jh, th):
        assert a.status == b.status == "done"
        assert b.prefix_hit_tokens == a.prefix_hit_tokens
        assert_gaps(model, p, b.tokens, f"prompt of {len(p)}")
        assert list(a.tokens) == list(b.tokens), f"prompt of {len(p)}: JAX {a.tokens} != port {b.tokens}"
    js, ts = jeng.metrics_snapshot(), teng.metrics_snapshot()
    assert {k: ts[k] for k in PREFIX_KEYS} == {k: js[k] for k in PREFIX_KEYS}
    # the four shared-prefix requests after the first hit both whole chunks
    assert [h.prefix_hit_tokens for h in th[1:4]] == [2 * CHUNK] * 3
    assert ts["prefix_hits"] >= 6 and ts["cow_copies"] == 0
    # after retirement only the index holds pages, one reference each
    banked = [p for pages in teng._prefix_cache._entries.values() for p in pages]
    assert all(teng.slots.pool.refs[p] == 1 for p in banked)
    assert teng.slots.pool.in_use == len(banked) and teng.slots.pool.reserved == 0


def test_small_pool_page_faults_match_jax(pair):
    """A pool of 64 positions (8 pages): each request needs 6; the index
    holds pages of earlier prompts, so admissions fault and reclaim. The
    counts and the streams must equal JAX's."""
    jcfg, params, model = pair
    prompts = [_prompt(40, offset=o) for o in (3, 50, 97, 3)]
    kw = dict(prefix_cache_chunks=8, page_pool_tokens=64)
    jeng, teng = jax_engine(jcfg, params, **kw), port_engine(model, **kw)
    for eng, hs in ((jeng, []), (teng, [])):
        for p in prompts:
            hs.append(eng.submit(p, max_new_tokens=8))
            eng.run_until_idle()
        eng._handles = hs
    for p, a, b in zip(prompts, jeng._handles, teng._handles):
        assert a.status == b.status == "done"
        assert list(a.tokens) == list(b.tokens)
    js, ts = jeng.metrics_snapshot(), teng.metrics_snapshot()
    assert {k: ts[k] for k in PREFIX_KEYS} == {k: js[k] for k in PREFIX_KEYS}
    assert ts["page_faults"] > 0 and ts["pages_reclaimed"] > 0


def test_prefix_hit_is_refcount_not_copy(pair):
    _, _, model = pair
    engine = port_engine(model, prefix_cache_chunks=16)
    prefix = _prompt(16, offset=40)
    a = engine.submit(prefix + _prompt(3, offset=7), max_new_tokens=6)
    engine.run_until_idle()
    banked = [p for pages in engine._prefix_cache._entries.values() for p in pages]
    assert banked and all(engine.slots.pool.refs[p] == 1 for p in banked)
    b = engine.submit(prefix + _prompt(4, offset=90), max_new_tokens=6)
    engine.step()  # admission shares the index's pages with the new slot
    assert all(engine.slots.pool.refs[p] == 2 for p in banked)
    slot = next(s for s, act in enumerate(engine._active) if act is not None and act.handle is b)
    assert [int(p) for p in engine.slots.table[slot, :len(banked)]] == banked
    engine.run_until_idle()
    assert b.prefix_hit_tokens == 16 and a.status == b.status == "done"
    # the hit stream equals a cold engine's
    cold = port_engine(model)
    c = cold.submit(prefix + _prompt(4, offset=90), max_new_tokens=6)
    cold.run_until_idle()
    assert c.tokens == b.tokens
    assert engine.metrics_snapshot()["prefix_hits"] == 1 and engine.slots.cow_copies == 0


def test_release_never_frees_index_held_pages(pair):
    _, _, model = pair
    engine = port_engine(model, n_slots=1, prefix_cache_chunks=16)
    engine.submit(_prompt(16, offset=3) + [7, 8], max_new_tokens=4)
    engine.run_until_idle()
    banked = [p for pages in engine._prefix_cache._entries.values() for p in pages]
    assert banked and all(engine.slots.pool.refs[p] == 1 for p in banked)
    before = engine.slots.pool.in_use
    engine._prefix_cache.flush()
    assert all(engine.slots.pool.refs[p] == 0 for p in banked)
    assert engine.slots.pool.in_use == before - len(banked)


def test_index_eviction_is_refcount_aware(pair):
    _, _, model = pair
    engine = port_engine(model, n_slots=1, prefix_cache_chunks=2)
    hog = engine.submit(_prompt(16, offset=11) + [9], max_new_tokens=20)
    for _ in range(4):
        engine.step()
    assert hog.status == "running"
    banked = [p for pages in engine._prefix_cache._entries.values() for p in pages]
    assert banked and all(engine.slots.pool.refs[p] == 2 for p in banked)
    assert engine._prefix_cache.reclaim(len(banked)) == 0 and len(engine._prefix_cache) == 1
    engine.run_until_idle()
    assert hog.status == "done"
    assert engine._prefix_cache.reclaim(len(banked)) == len(banked)
    assert all(engine.slots.pool.refs[p] == 0 for p in banked)


def test_admission_waits_when_pool_exhausted(pair):
    _, _, model = pair
    engine = port_engine(model, page_pool_tokens=32)
    a = engine.submit(_prompt(8), max_new_tokens=12)
    b = engine.submit(_prompt(8, offset=30), max_new_tokens=12)
    for _ in range(3):
        engine.step()
    assert a.status == "running" and b.status == "queued" and engine.queue_depth == 1
    engine.run_until_idle()
    assert a.status == b.status == "done" and engine.stats["preemptions"] == 0


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_cow_copies_a_shared_page(kv):
    """The guard's device half: a slot about to write into a page another
    holder shares gets a private copy with the same rows (K, V and the int8
    scales), and the shared page keeps its other holder."""
    model = model_getter("test", device="cpu", seed=0, kv_cache_dtype=kv)
    engine = port_engine(model)
    slots = engine.slots
    s0, s1 = slots.acquire(), slots.acquire()
    slots.reserve(s0, 16)
    assert slots.ensure(s0, 16)
    for layer in engine.pools:
        for pool in (layer.k, layer.v, layer.k_scale, layer.v_scale):
            if pool is not None:
                pool.copy_(torch.randn(pool.shape).to(pool.dtype) if pool.dtype != torch.int8
                           else torch.randint(-127, 128, pool.shape, dtype=torch.int8))
    pages = slots.bank(s0, 2)
    slots.share(s1, pages)
    assert [slots.pool.refs[p] for p in pages] == [3, 3]
    assert slots.cow(s1, 1, engine._copy_page)
    fresh = int(slots.table[s1, 1])
    assert fresh not in pages and slots.cow_copies == 1
    assert [slots.pool.refs[p] for p in pages] == [3, 2] and slots.pool.refs[fresh] == 1
    for layer in engine.pools:
        for pool in (layer.k, layer.v, layer.k_scale, layer.v_scale):
            if pool is not None:
                assert torch.equal(pool[fresh], pool[pages[1]])
    assert slots.cow(s1, 1, engine._copy_page) and slots.cow_copies == 1  # private now: no copy
    assert slots.cow(s1, 5, engine._copy_page)  # unmapped block: nothing to guard


def test_int8_kv_prefix_hit_matches_cold(pair):
    """An int8 KV cache: a hit's stream reads the shared int8 pages and
    equals a cold engine's."""
    model = model_getter("test", device="cpu", seed=0, kv_cache_dtype="int8")
    prompt = SYSTEM + SUFFIXES[1]
    cold = port_engine(model)
    ref = cold.submit(prompt, max_new_tokens=MAX_NEW)
    cold.run_until_idle()
    engine = port_engine(model, prefix_cache_chunks=16)
    hs = _serve(engine, SYSTEM + SUFFIXES[0], [prompt])
    assert hs[1].prefix_hit_tokens == 2 * CHUNK and hs[1].tokens == ref.tokens


def test_reload_flushes_the_index(pair):
    _, _, model = pair
    engine = port_engine(model, prefix_cache_chunks=16)
    _serve(engine, SYSTEM + SUFFIXES[0], [])
    assert len(engine._prefix_cache) == 2
    engine.reload_params({k: v.clone() for k, v in engine.model.state_dict().items()})
    engine.step()
    assert len(engine._prefix_cache) == 0 and engine.slots.pool.in_use == 0
    assert engine.metrics_snapshot()["prefix_entries"] == 0


def test_paged_kv_cache_share_requires_empty_slot():
    slots = PagedKVCache(2, 9, PAGE, 32)
    s = slots.acquire()
    slots.reserve(s, 16)
    slots.ensure(s, 8)
    with pytest.raises(ValueError):
        slots.share(s, [1])
