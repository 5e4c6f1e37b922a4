"""Disaggregated prefill/decode roles and live stream migration in the port,
against the JAX package (``tests/test_serving_disagg.py`` is JAX's own).

- The wire format (``serving/wire.py``) writes JAX's bytes for the same
  float32, int8 and bfloat16 payloads; each package decodes the other's
  blobs; a torn blob raises ValueError; bfloat16 decodes with
  ``ml_dtypes`` blocked from import.
- Page spans round-trip bit for bit (page sizes 8 and 64, int8 scale
  pools, ragged tables), conserve refcounts, and imported pages are
  guarded by copy-on-write. A span carries JAX's cache keys and layout, so
  it imports into a JAX ``PagedKVCache`` and back.
- Engines: a stream moved mid-decode, mid-prefill, on a speculative
  engine, or handed off by a prefill-role engine continues greedily to
  JAX ``generate``'s tokens with no prefill work for the moved prefix on
  the receiver; sampled streams moved between port engines equal the
  port's unmoved stream (the generator state moves); a ``draft_k``
  mismatch and a failed ship are retryable; the role contracts are JAX's.
  One case each way crosses packages: a JAX engine's blob continues in a
  port decode engine, and a port engine's in a JAX one.

The ``test`` model in float32 with JAX's init times four (greedy rows vary),
cache 48, chunk 8, page 4, as JAX's disagg tests.
"""
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import WEIGHT_SCALE, assert_gaps, make_pair
from zero_transformer_tpu.inference.generate import decode_model as jax_decode_model
from zero_transformer_tpu.inference.generate import generate as jax_generate
from zero_transformer_tpu.inference.sampling import SamplingConfig as JaxSampling
from zero_transformer_tpu.serving import PagedKVCache as JaxPagedKVCache
from zero_transformer_tpu.serving import ServingEngine as JaxEngine
from zero_transformer_tpu.serving import page_span_from_wire as jax_from_wire
from zero_transformer_tpu.serving import page_span_to_wire as jax_to_wire
from zero_transformer_tpu_torch.config import model_config
from zero_transformer_tpu_torch.inference.generate import allocate_pools
from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
from zero_transformer_tpu_torch.serving import PagedKVCache, ServingEngine, page_span_from_wire, page_span_to_wire
from zero_transformer_tpu_torch.serving.slots import span_keys

torch.set_num_threads(1)

CACHE_LEN, CHUNK, PAGE = 48, 8, 4
SAMPLING = SamplingConfig(temperature=0.9, top_k=20)
GREEDY = SamplingConfig(greedy=True)


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=0, scale=WEIGHT_SCALE)


def _prompt(length, offset=0):
    return [(3 + offset + i) % 250 + 1 for i in range(length)]


def jax_reference(pair, prompt, max_new):
    """JAX ``generate``'s greedy tokens for ``prompt``."""
    jcfg, params, _ = pair
    toks = jax_generate(jax_decode_model(jcfg, CACHE_LEN), params, jnp.asarray([prompt], jnp.int32), max_new,
                        jax.random.PRNGKey(0), JaxSampling(greedy=True))
    return jax.device_get(toks)[0].tolist()


def engine(pair, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("sampling", GREEDY)
    kw.setdefault("prefill_chunk", CHUNK)
    kw.setdefault("page_size", PAGE)
    return ServingEngine(pair[2], device="cpu", **kw)


def jax_engine(pair, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("sampling", JaxSampling(greedy=True))
    kw.setdefault("prefill_chunk", CHUNK)
    kw.setdefault("page_size", PAGE)
    return JaxEngine(pair[0], pair[1], kv_layout="paged", **kw)


def shipper(dest, captured, encode=page_span_to_wire, decode=page_span_from_wire):
    """An in-process page shipper through the wire format: encode, decode,
    import into ``dest``."""

    def ship(payload, target, on_done):
        handle = dest.import_stream(decode(encode(payload)))
        captured.append(handle)
        on_done(None if handle.status in ("queued", "running") else (handle.error or handle.status))

    return ship


# ---------------------------------------------------------------- the wire


def _jax_kv(int8=False, page=PAGE, cache_len=32, n_pages=17):
    kw = {"kv_cache_dtype": "int8"} if int8 else {}
    from zero_transformer_tpu.config import model_config as jax_model_config

    jcfg = jax_model_config("test", dropout=0.0, compute_dtype="float32", **kw)
    return JaxPagedKVCache(jax_decode_model(jcfg, cache_len, kv_pages=(n_pages, page)), n_slots=2)


def _numpy_payload(jkv, n_blocks, rng, bf16=False):
    """A random span over JAX ``jkv``'s pool leaves (numpy), with carry
    leaves and JSON extras beside it. ``bf16``: the float leaves as
    ml_dtypes bfloat16 (finite values)."""
    import ml_dtypes

    leaves = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jkv.cache):
        if str(path[-1].key) not in ("cached_key", "cached_value", "key_scale", "value_scale"):
            continue
        ax = leaf.ndim - 4
        shape = (n_blocks,) + tuple(d for i, d in enumerate(leaf.shape) if i != ax)
        dt = np.dtype(leaf.dtype)
        if dt.kind == "f":
            arr = rng.standard_normal(shape).astype(ml_dtypes.bfloat16 if bf16 else dt)
        else:
            arr = rng.integers(-128, 127, size=shape, dtype=dt)
        leaves[jax.tree_util.keystr(path)] = arr
    leaves["carry/last_logits"] = rng.standard_normal(256).astype(np.float32)
    leaves["carry/gen_mask"] = rng.random(256) < 0.1
    leaves["carry/rng"] = np.array([0, 7], np.uint32)
    leaves["carry/torch_rng"] = rng.integers(0, 255, size=16, dtype=np.uint8)
    return {"request_id": "r-1", "prompt": [5, 6, 7], "max_new_tokens": 4, "seed": 7, "deadline_s": None,
            "draft_k": 0, "ledger": {"prefill_chunks": 2, "queue_ms": 1.5}, "hop": None, "kind": "decode",
            "veto": -1, "page_size": jkv.page_size, "n_blocks": n_blocks, "n_tokens": n_blocks * jkv.page_size,
            "leaves": leaves}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).view(np.uint8).tobytes()


@pytest.mark.parametrize("kind", ["float32", "int8", "bfloat16"])
def test_wire_bytes_equal_jax(kind):
    """The port writes JAX's exact bytes for the same payload: numpy leaves
    as given to JAX, and torch tensors holding the same values (bfloat16
    as a torch bfloat16 tensor of the same bits)."""
    rng = np.random.default_rng(0)
    payload = _numpy_payload(_jax_kv(int8=kind == "int8"), 3, rng, bf16=kind == "bfloat16")
    want = jax_to_wire(payload)
    assert page_span_to_wire(payload) == want
    as_torch = {k: (torch.from_numpy(v.view(np.uint16).copy()).view(torch.bfloat16) if v.dtype.kind == "V"
                    else torch.from_numpy(np.array(v))) for k, v in payload["leaves"].items()}
    assert page_span_to_wire({**payload, "leaves": as_torch}) == want
    if kind == "bfloat16":
        assert b'"dtype": "bfloat16"' in want


@pytest.mark.parametrize("kind", ["float32", "int8", "bfloat16"])
def test_each_package_decodes_the_others_blobs(kind):
    rng = np.random.default_rng(1)
    payload = _numpy_payload(_jax_kv(int8=kind == "int8"), 2, rng, bf16=kind == "bfloat16")
    ours = page_span_from_wire(jax_to_wire(payload))
    theirs = jax_from_wire(page_span_to_wire(payload))
    for back in (ours, theirs):
        assert {k: v for k, v in back.items() if k != "leaves"} == {k: v for k, v in payload.items()
                                                                     if k != "leaves"}
        assert set(back["leaves"]) == set(payload["leaves"])
        for key, arr in payload["leaves"].items():
            got = back["leaves"][key]
            assert tuple(got.shape) == arr.shape and _bits(got) == _bits(arr), key
    assert ours["leaves"]["carry/rng"].dtype == torch.uint32
    if kind == "bfloat16":
        assert ours["leaves"]["['blocks']['attn']['cached_key']"].dtype == torch.bfloat16


def test_wire_rejects_torn_blobs():
    with pytest.raises(ValueError):
        page_span_from_wire(b"not a span")
    blob = page_span_to_wire({"page_size": 4, "n_blocks": 1, "n_tokens": 4,
                              "leaves": {"x": torch.arange(8, dtype=torch.int8)}})
    with pytest.raises(ValueError):
        page_span_from_wire(blob[:-3])  # truncated mid-buffer
    with pytest.raises(ValueError):
        page_span_from_wire(blob[:12])  # torn header
    foreign = blob.replace(b'"|i1"', b'"|V1"')
    with pytest.raises(ValueError, match="dtype"):
        page_span_from_wire(foreign)
    assert page_span_from_wire(blob)["leaves"]["x"].tolist() == list(range(8))


def test_bfloat16_decodes_without_ml_dtypes(monkeypatch):
    """The card has no ml_dtypes: the port reads and writes bfloat16
    through its 16-bit pattern, never through numpy's dtype table."""
    bits = torch.from_numpy(np.random.default_rng(3).integers(0, 2**15, size=32).astype(np.int16))
    x = bits.view(torch.bfloat16).reshape(2, 16)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # any import of it now raises
    with pytest.raises(ImportError):
        import ml_dtypes  # noqa: F401
    blob = page_span_to_wire({"page_size": 4, "n_blocks": 2, "n_tokens": 8, "leaves": {"x": x}})
    back = page_span_from_wire(blob)["leaves"]["x"]
    assert back.dtype == torch.bfloat16 and torch.equal(back.view(torch.int16), x.view(torch.int16))


# ------------------------------------------------------------ page spans


def _port_kv(int8=False, page=PAGE, cache_len=32, n_pages=17, n_slots=2):
    cfg = model_config("test", dropout=0.0, compute_dtype="float32", kv_cache_dtype="int8" if int8 else "auto")
    pools = allocate_pools(cfg, n_pages, page, "cpu")
    return cfg, PagedKVCache(n_slots, n_pages, page, cache_len), pools


def _torch_payload(pools, kv, n_blocks, gen):
    """A random span over the port's pools (torch leaves)."""
    leaves = {}
    for key, layers in span_keys(pools).items():
        shape = (n_blocks, len(layers)) + tuple(layers[0].shape[1:])
        if layers[0].dtype.is_floating_point:
            leaves[key] = torch.randn(shape, generator=gen).to(layers[0].dtype)
        else:
            leaves[key] = torch.randint(-128, 127, shape, generator=gen, dtype=layers[0].dtype)
    return {"page_size": kv.page_size, "n_blocks": n_blocks, "n_tokens": n_blocks * kv.page_size, "leaves": leaves}


@pytest.mark.parametrize("page_size,int8", [(8, False), (8, True), (64, False)])
def test_page_span_roundtrip_bitwise(page_size, int8):
    cache_len = max(2 * page_size, 16)
    n_pages = (cache_len * 2) // page_size + 1
    _, kv, pools = _port_kv(int8, page_size, cache_len, n_pages)
    payload = _torch_payload(pools, kv, 2, torch.Generator().manual_seed(0))
    if int8:
        assert {"['blocks']['attn']['key_scale']", "['blocks']['attn']['value_scale']"} <= set(payload["leaves"])
    free0 = kv.pool.free_count
    slot = kv.acquire()
    assert kv.import_page_span(slot, payload, pools)
    out = kv.export_page_span(slot, payload["n_tokens"], pools)
    assert out["n_blocks"] == 2
    for key, arr in payload["leaves"].items():
        got = out["leaves"][key]
        assert got.dtype == arr.dtype and got.shape == arr.shape and _bits(got) == _bits(arr), key
    back = page_span_from_wire(page_span_to_wire({**out, "kind": "decode", "veto": -1}))
    assert back["kind"] == "decode" and back["veto"] == -1
    for key, arr in out["leaves"].items():
        assert _bits(back["leaves"][key]) == _bits(arr)
    assert kv.pool.free_count == free0 - 2
    kv.release([slot])
    assert kv.pool.free_count == free0 and all(r == 0 for r in kv.pool.refs[1:])


def test_page_span_ragged_tables_and_exact_gather():
    """Slots with spans of 1, 3 and 5 blocks move independently; the port
    gathers exactly the slot's pages (no padding to a power of two)."""
    _, kv, pools = _port_kv(n_pages=17, n_slots=3)
    gen = torch.Generator().manual_seed(1)
    payloads = {}
    for blocks in (1, 3, 5):
        slot = kv.acquire()
        payloads[slot] = _torch_payload(pools, kv, blocks, gen)
        assert kv.import_page_span(slot, payloads[slot], pools)
    for slot, payload in payloads.items():
        out = kv.export_page_span(slot, payload["n_tokens"], pools)
        assert out["n_blocks"] == payload["n_blocks"]
        for key, arr in payload["leaves"].items():
            assert out["leaves"][key].shape[0] == payload["n_blocks"] and _bits(out["leaves"][key]) == _bits(arr)
    with pytest.raises(ValueError, match="maps"):
        kv.export_page_span(0, 3 * kv.page_size, pools)


def test_import_validates_and_rolls_back():
    _, kv, pools = _port_kv(n_pages=5)  # 4 real pages
    gen = torch.Generator().manual_seed(2)
    slot = kv.acquire()
    payload = _torch_payload(pools, kv, 2, gen)
    for bad, match in ((dict(payload, page_size=8), "page_size"), (dict(payload, n_blocks=9), "capacity"),
                       (dict(payload, leaves={}), "leaves"),
                       (dict(payload, leaves={k: v.double() for k, v in payload["leaves"].items()}), "leaf")):
        with pytest.raises(ValueError, match=match):
            kv.import_page_span(slot, bad, pools)
    big = _torch_payload(pools, kv, 5, gen)
    assert not kv.import_page_span(slot, big, pools)  # 5 blocks, 4 pages: rolled back
    assert kv.pool.free_count == 4 and kv.alloc_blocks[slot] == 0
    assert kv.import_page_span(slot, payload, pools)
    with pytest.raises(ValueError, match="empty slot"):
        kv.import_page_span(slot, payload, pools)


def test_imported_pages_are_cow_protected():
    _, kv, pools = _port_kv()
    payload = _torch_payload(pools, kv, 2, torch.Generator().manual_seed(3))
    slot = kv.acquire()
    assert kv.import_page_span(slot, payload, pools)
    pages = kv.bank(slot, 2)
    assert all(kv.pool.refs[p] == 2 for p in pages)

    def copy_page(src, dst):
        for layer in pools:
            layer.k[dst], layer.v[dst] = layer.k[src], layer.v[src]

    assert kv.cow(slot, 0, copy_page) and kv.cow_copies == 1
    assert int(kv.table[slot, 0]) != pages[0]
    out = kv.export_page_span(slot, payload["n_tokens"], pools)
    for key, arr in payload["leaves"].items():
        assert _bits(out["leaves"][key]) == _bits(arr)
    assert kv.pool.refs[pages[0]] == 1  # only the bank's hold remains


@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
def test_span_crosses_packages(int8):
    """JAX's span imports into the port's pools and exports the same bytes;
    the port's span imports into a JAX cache and exports the same bytes."""
    jkv = _jax_kv(int8=int8)
    payload = _numpy_payload(jkv, 3, np.random.default_rng(4))
    payload["leaves"] = {k: v for k, v in payload["leaves"].items() if not k.startswith("carry/")}
    _, kv, pools = _port_kv(int8=int8)
    slot = kv.acquire()
    assert kv.import_page_span(slot, page_span_from_wire(jax_to_wire(payload)), pools)
    out = kv.export_page_span(slot, payload["n_tokens"], pools)
    assert jax_to_wire(payload) == page_span_to_wire({**payload, "leaves": out["leaves"]})
    jslot = jkv.acquire()
    assert jkv.import_page_span(jslot, jax_from_wire(page_span_to_wire(out)))
    back = jkv.export_page_span(jslot, payload["n_tokens"])
    for key, arr in payload["leaves"].items():
        assert _bits(back["leaves"][key]) == _bits(arr), key


# --------------------------------------------------------------- engines


def _migrate(src, handle, at_tokens, target="peer://dst"):
    while len(handle.tokens) < at_tokens:
        src.step()
    assert src.request_migration(handle.rid, target)
    src.step()
    assert handle.status == "migrated", (handle.status, handle.error)
    assert handle.migrated_to == target


def test_decode_migration_is_jax_generate_and_replays_zero(pair):
    captured = []
    dst = engine(pair, role="decode")
    src = engine(pair, page_shipper=shipper(dst, captured))
    prompt = _prompt(13)
    expect = jax_reference(pair, prompt, 10)
    assert_gaps(pair[2], prompt, expect, "decode migration")
    handle = src.submit(prompt, max_new_tokens=10, seed=5)
    _migrate(src, handle, 4)
    cont = captured[0]
    dst.run_until_idle()
    assert cont.status == "done", (cont.status, cont.error)
    assert handle.tokens + cont.tokens == expect
    assert dst.stats["prefill_chunks"] == 0 and dst.stats["import_replayed_tokens"] == 0
    assert dst.stats["migrations_in"] == 1 and src.stats["migrations_out"] == 1
    assert src.migrations_in_flight == 0 and cont.rid == handle.rid
    assert cont.ledger["migrations"] == 1 and cont.ledger["prefill_chunks"] == 2  # carried from the source
    # the source freed every page; the receiver holds none after retirement
    assert src.slots.pool.in_use == 0 and dst.slots.pool.in_use == 0


def test_midprefill_migration_is_jax_generate(pair):
    captured = []
    dst = engine(pair, role="decode")
    src = engine(pair, page_shipper=shipper(dst, captured))
    prompt = _prompt(30, offset=4)
    expect = jax_reference(pair, prompt, 6)
    assert_gaps(pair[2], prompt, expect, "mid-prefill migration")
    handle = src.submit(prompt, max_new_tokens=6, seed=9)
    src.step()  # one 8-token chunk of the 30-token prompt
    assert handle.tokens == []
    _migrate(src, handle, 0)
    cont = captured[0]
    dst.run_until_idle()
    assert cont.status == "done" and cont.tokens == expect
    # the receiver ran only the remaining chunks
    assert dst.stats["prefill_chunks"] == -(-len(prompt) // CHUNK) - 1


@pytest.mark.parametrize("where", ["decode", "prefill"])
def test_sampled_migration_equals_the_unmoved_stream(pair, where):
    """The generator's state moves with the stream: a sampled stream moved
    between port engines draws what it would have drawn unmoved."""
    ref = engine(pair, sampling=SAMPLING)
    prompt = _prompt(21, offset=2)
    unmoved = ref.submit(prompt, max_new_tokens=12, seed=11)
    ref.run_until_idle()
    captured = []
    dst = engine(pair, role="decode", sampling=SAMPLING)
    src = engine(pair, sampling=SAMPLING, page_shipper=shipper(dst, captured))
    handle = src.submit(prompt, max_new_tokens=12, seed=11)
    if where == "prefill":
        src.step()
    _migrate(src, handle, 5 if where == "decode" else 0)
    dst.run_until_idle()
    assert handle.tokens + captured[0].tokens == unmoved.tokens
    assert len(set(unmoved.tokens)) > 3  # really sampled


def test_spec_engine_migration_keeps_greedy_identity(pair):
    captured = []
    dst = engine(pair, role="decode", draft_k=2)
    src = engine(pair, draft_k=2, page_shipper=shipper(dst, captured))
    prompt = _prompt(11, offset=7)
    expect = jax_reference(pair, prompt, 10)
    handle = src.submit(prompt, max_new_tokens=10, seed=1)
    _migrate(src, handle, 3)
    cont = captured[0]
    dst.run_until_idle()
    assert cont.status == "done", (cont.status, cont.error)
    assert (handle.tokens + cont.tokens)[:len(expect)] == expect
    assert dst.stats["prefill_chunks"] == 0


def test_draft_k_mismatch_degrades_to_recompute(pair):
    captured = []
    dst = engine(pair, role="decode", draft_k=0)
    src = engine(pair, draft_k=2, page_shipper=shipper(dst, captured))
    handle = src.submit(_prompt(9), max_new_tokens=6, seed=0)
    while len(handle.tokens) < 2:
        src.step()
    assert src.request_migration(handle.rid, "x")
    src.step()
    assert handle.status == "failed" and handle.retryable, (handle.status, handle.error)
    assert src.stats["migration_failures"] == 1
    assert captured[0].status == "rejected" and captured[0].retryable


def test_prefill_handoff_and_role_contracts(pair):
    captured = []
    dst = engine(pair, role="decode")
    pre = engine(pair, role="prefill", page_shipper=shipper(dst, captured), prefix_cache_chunks=16)
    prompt = _prompt(13)
    expect = jax_reference(pair, prompt, 8)
    handle = pre.submit(prompt, max_new_tokens=8, seed=3, prefill_to="http://dst")
    pre.run_until_idle()
    assert handle.status == "migrated" and handle.migrated_to == "http://dst"
    assert pre.stats["decode_ticks"] == 0 and pre.stats["prefill_handoffs"] == 1
    # the prefill replica banked the prompt's chunk before detaching the slot
    assert pre.metrics_snapshot()["prefix_entries"] == 1
    cont = captured[0]
    dst.run_until_idle()
    assert cont.status == "done" and cont.tokens == expect
    assert dst.stats["prefill_chunks"] == 0
    bare = pre.submit(prompt, max_new_tokens=4)
    assert bare.status == "rejected" and "prefill_to" in bare.error
    carry = {"carry/last_logits": np.zeros(256, np.float32), "carry/gen_mask": np.zeros(256, np.bool_),
             "carry/rng": np.zeros(2, np.uint32)}
    back = pre.import_stream({"prompt": prompt, "max_new_tokens": 4, "kind": "decode", "page_size": PAGE,
                              "n_blocks": 0, "leaves": carry})
    assert back.status == "rejected" and "prefill-role" in back.error
    torn = dst.import_stream({"kind": "decode", "leaves": {}})
    assert torn.status == "rejected" and torn.retryable and "bad import payload" in torn.error
    with pytest.raises(ValueError, match="role"):
        engine(pair, role="router")
    with pytest.raises(ValueError, match="draft_k"):
        engine(pair, role="prefill", draft_k=2)


def test_handoff_ships_jax_rng_key_and_generator_state(pair):
    """The handoff's carry: JAX's ``PRNGKey(seed)`` for a JAX peer, the
    port generator seeded from the request for a port peer, the logits row
    of the prompt's last position, a cleared mask."""
    payloads = []
    pre = engine(pair, role="prefill", page_shipper=lambda p, t, done: (payloads.append(p), done(None)))
    prompt = _prompt(13)
    for seed in (3, 2**31 - 5):
        pre.submit(prompt, max_new_tokens=4, seed=seed, prefill_to="d")
        pre.run_until_idle()
        leaves = payloads[-1]["leaves"]
        assert np.array_equal(leaves["carry/rng"].numpy(), np.asarray(jax.random.PRNGKey(seed)))
        want = torch.Generator().manual_seed(seed).get_state()
        assert torch.equal(leaves["carry/torch_rng"], want)
        assert not leaves["carry/gen_mask"].any() and payloads[-1]["veto"] == -1
    with torch.no_grad():
        row = pair[2](torch.tensor([prompt]))[0, -1].float()
    torch.testing.assert_close(leaves["carry/last_logits"], row, atol=1e-5, rtol=0)


def test_migration_failure_dumps_flight_and_fails_retryably(pair, tmp_path):
    src = engine(pair, page_shipper=lambda payload, target, on_done: on_done("target unreachable (chaos)"),
                 obs_dir=str(tmp_path))
    handle = src.submit(_prompt(9), max_new_tokens=6, seed=0)
    while len(handle.tokens) < 2:
        src.step()
    assert src.request_migration(handle.rid, "dead://")
    src.step()
    assert handle.status == "failed" and handle.retryable and "migration failed" in handle.error
    assert src.stats["migration_failures"] == 1 and src.migrations_in_flight == 0
    assert list((tmp_path / "flightrec").glob("*migration_failed*"))
    assert src.slots.pool.in_use == 0


def test_migrate_all_and_unknown_stream(pair):
    captured = []
    dst = engine(pair, role="decode")
    src = engine(pair, page_shipper=shipper(dst, captured))
    prompts = [_prompt(9), _prompt(20, offset=3)]
    expects = [jax_reference(pair, p, 6) for p in prompts]
    handles = [src.submit(p, max_new_tokens=6) for p in prompts]
    src.step()
    src.step()
    assert not src.request_migration("no-such-stream", "x")
    assert src.request_migrate_all("peer://dst") == 2
    src.step()
    assert [h.status for h in handles] == ["migrated", "migrated"]
    dst.run_until_idle()
    by_rid = {c.rid: c for c in captured}
    for h, want in zip(handles, expects):
        assert h.tokens + by_rid[h.rid].tokens == want
    snap = dst.metrics_snapshot()
    assert (snap["role"], snap["migrations_in"], snap["pending_imports"]) == ("decode", 2, 0)
    assert "serve_migrations_in_total 2" in dst.prometheus_text()


def test_threaded_ship_answers_keep_the_counters(pair):
    """Ship answers arrive on other threads while the tick thread exports
    and decodes: every stream ends migrated and the in-flight gauge returns
    to zero (a lost update under the lock would leave it off)."""
    import random
    import threading

    answers = []

    def shipper(payload, target, on_done):
        t = threading.Thread(target=lambda: (time.sleep(random.random() * 1e-3), on_done(None)))
        answers.append(t)
        t.start()

    src = engine(pair, n_slots=4, page_shipper=shipper)
    handles = [src.submit(_prompt(9 + i % 5, offset=i), max_new_tokens=6) for i in range(12)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        deadline = time.monotonic() + 60
        while any(h.status in ("queued", "running") for h in handles) and time.monotonic() < deadline:
            src.step()
            src.request_migrate_all("peer://dst")
    finally:
        sys.setswitchinterval(old)
    for t in answers:
        t.join(timeout=10)
        assert not t.is_alive()
    assert all(h.status == "migrated" for h in handles), [h.status for h in handles]
    assert src.stats["migrations_out"] == 12 and src.migrations_in_flight == 0
    assert src.slots.pool.in_use == 0 and src.slots.free_count == 4


def test_drain_rejects_pending_imports(pair):
    dst = engine(pair, role="decode")
    payloads = []
    src = engine(pair, page_shipper=lambda p, t, done: (payloads.append(p), done(None)))
    h = src.submit(_prompt(9), max_new_tokens=6)
    _migrate(src, h, 2)
    imported = dst.import_stream(payloads[0])
    assert imported.status == "queued" and dst.metrics_snapshot()["pending_imports"] == 1
    dst.begin_drain(5.0)
    assert imported.status == "rejected" and imported.retryable
    assert dst.poll_drain()


# ------------------------------------------------------------ cross-package


@pytest.mark.parametrize("how", ["handoff", "decode"])
def test_jax_stream_continues_in_a_port_engine(pair, how):
    """A JAX engine's blob (a prefill handoff, or a mid-decode migration)
    continues greedily in a port decode engine to JAX's tokens, with no
    prefill work there."""
    captured = []
    dst = engine(pair, role="decode")
    ship = shipper(dst, captured, encode=jax_to_wire, decode=page_span_from_wire)
    prompt = _prompt(17, offset=5)
    expect = jax_reference(pair, prompt, 10)
    if how == "handoff":
        src = jax_engine(pair, role="prefill", page_shipper=ship)
        handle = src.submit(prompt, max_new_tokens=10, seed=2, prefill_to="http://port")
        src.run_until_idle()
        assert handle.status == "migrated", (handle.status, handle.error)
    else:
        src = jax_engine(pair, page_shipper=ship)
        handle = src.submit(prompt, max_new_tokens=10, seed=2)
        _migrate(src, handle, 3)
    cont = captured[0]
    dst.run_until_idle()
    assert cont.status == "done", (cont.status, cont.error)
    assert handle.tokens + cont.tokens == expect
    assert dst.stats["prefill_chunks"] == 0 and dst.stats["migrations_in"] == 1


@pytest.mark.parametrize("how", ["handoff", "decode"])
def test_port_stream_continues_in_a_jax_engine(pair, how):
    captured = []
    dst = jax_engine(pair, role="decode")
    ship = shipper(dst, captured, encode=page_span_to_wire, decode=jax_from_wire)
    prompt = _prompt(19, offset=1)
    expect = jax_reference(pair, prompt, 10)
    if how == "handoff":
        src = engine(pair, role="prefill", page_shipper=ship)
        handle = src.submit(prompt, max_new_tokens=10, seed=4, prefill_to="http://jax")
        src.run_until_idle()
        assert handle.status == "migrated", (handle.status, handle.error)
    else:
        src = engine(pair, page_shipper=ship)
        handle = src.submit(prompt, max_new_tokens=10, seed=4)
        _migrate(src, handle, 3)
    cont = captured[0]
    dst.run_until_idle()
    assert cont.status == "done", (cont.status, cont.error)
    assert handle.tokens + cont.tokens == expect
    assert dst.stats["prefill_chunks"] == 0 and dst.stats["migrations_in"] == 1
