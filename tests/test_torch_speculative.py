"""PyTorch port vs JAX reference: prompt-lookup speculative decoding, one
shot (``generate_speculative``) and in the serving engine (``draft_k``), on
the CPU in float32, each bar stated where it is checked:

- ``ngram_propose`` equal to JAX's on random histories (hypothesis), with
  ``k``, ``n``, ``skip`` and ``window`` varied;
- ``generate_speculative`` tokens equal to the port's greedy ``generate``
  and to JAX ``generate_speculative``, and its ``forwards`` equal to JAX's:
  penalty 1.0 and 1.3, temperature 0.7, EOS, ``draft_len`` 4 (verify
  windows the paged decode path takes) and 8 (windows of 9, the flash
  path), an int8 cache, on prompts where drafts are partly accepted and
  partly rejected (so the rewound cursor and the stale K/V past it are
  exercised);
- learned positions: tokens equal to the port's and JAX's greedy
  ``generate`` (JAX ``generate_speculative`` does not rewind its
  ``decode_pos``, so its learned-position output diverges from JAX's own
  greedy output; the port's positions follow the cursor);
- every guard of ``_start_decode`` and ``generate_speculative`` raises in
  both packages (one parametrised test over both);
- the engine at ``draft_k`` 4 and 8: greedy streams token-identical to the
  engine at ``draft_k`` 0 and to the JAX ``ServingEngine`` at the same
  ``draft_k``, with ``spec_ticks``, ``draft_tokens``, ``accepted_tokens``
  and ``acceptance_rate`` equal to JAX's; the sampled tick by its rule on a
  fixed draft (a rejected draft becomes the row's veto and is never the
  next token) and by distribution (the first two tokens' empirical joint
  distribution over 600 seeds within 0.1 total variation of the exact one
  from the model's logits, where plain sampling's own noise is ~0.05).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_generate import case_pair, make_pair
from zero_transformer_tpu.inference.generate import decode_model as jax_decode
from zero_transformer_tpu.inference.generate import generate as jax_generate
from zero_transformer_tpu.inference.generate import stream_tokens as jax_stream
from zero_transformer_tpu.inference.sampling import SamplingConfig as JaxSampling
from zero_transformer_tpu.inference.speculative import generate_speculative as jax_speculative
from zero_transformer_tpu.inference.speculative import ngram_propose as jax_ngram_propose
from zero_transformer_tpu.serving import ServingEngine as JaxEngine
from zero_transformer_tpu_torch.inference import (SamplingConfig, generate, generate_speculative, ngram_propose,
                                                  process_logits, stream_tokens)
from zero_transformer_tpu_torch.serving import ServingEngine

CACHE_LEN = 64
PERIOD = [7, 11, 13, 17, 19, 23]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@settings(max_examples=200, deadline=None)
@given(hist=st.lists(st.integers(0, 5), max_size=40), k=st.integers(0, 6), n=st.integers(1, 3),
       skip=st.integers(0, 2), window=st.integers(1, 40))
def test_ngram_propose_matches_jax(hist, k, n, skip, window):
    assert ngram_propose(hist, k, n=n, skip=skip, window=window) == jax_ngram_propose(
        hist, k, n=n, skip=skip, window=window)


def _spec_prompt(seed: int, length: int = 20) -> np.ndarray:
    """A repetitive prompt (so drafts are found) with a few random tokens
    (so some are rejected)."""
    x = np.array((PERIOD * 4)[:length])
    rng = np.random.default_rng(seed)
    x[rng.choice(length, 3, replace=False)] = rng.integers(1, 250, 3)
    return x[None]


def _partly_accepted_prompt(model, length, max_new, K, cache_len, **kw) -> np.ndarray:
    """The first of ``_spec_prompt``'s prompts on which ``model``'s drafts
    are partly accepted and partly rejected (more forwards than full
    acceptance takes, fewer than one a token)."""
    for seed in range(16):
        x = _spec_prompt(seed, length)
        _, stats = generate_speculative(model, torch.tensor(x), max_new, draft_len=K, return_stats=True,
                                        cache_len=cache_len, **kw)
        if -(-max_new // (K + 1)) + 1 < stats["forwards"] < max_new:
            return x
    raise AssertionError("no prompt with partly accepted drafts")


# (model, quant, draft_len, penalty, temperature, eos step)
SPEC = [
    ("gpt", "auto-none", 4, 1.0, 1.0, None),
    ("gpt", "auto-none", 8, 1.0, 1.0, None),
    ("gpt", "auto-none", 4, 1.3, 1.0, None),
    ("gpt", "auto-none", 4, 1.0, 0.7, None),
    ("gpt", "int8kv-none", 4, 1.0, 1.0, None),
    ("llama", "auto-none", 4, 1.0, 1.0, None),
    ("llama", "auto-none", 8, 1.3, 0.7, None),
    ("gpt", "auto-none", 4, 1.0, 1.0, 6),
    ("llama", "auto-none", 8, 1.0, 1.0, 9),
]


@pytest.mark.parametrize("name,quant,K,penalty,temperature,eos_step", SPEC,
                         ids=[f"{m}-{q}-K{k}-pen{p}-t{t}-eos{e}" for m, q, k, p, t, e in SPEC])
def test_speculative_matches_greedy_and_jax(name, quant, K, penalty, temperature, eos_step):
    jcfg, params, model = case_pair(name, quant)
    max_new = 30
    x = _partly_accepted_prompt(model, 20, max_new, K, CACHE_LEN, repetition_penalty=penalty,
                                temperature=temperature)
    sampling = SamplingConfig(greedy=True, repetition_penalty=penalty, temperature=temperature)
    greedy = generate(model, torch.tensor(x), max_new, sampling=sampling, cache_len=CACHE_LEN)
    eos = None if eos_step is None else int(greedy[0, eos_step])
    if eos is not None:
        greedy = generate(model, torch.tensor(x), max_new, sampling=sampling, eos_token_id=eos, pad_token_id=0,
                          cache_len=CACHE_LEN)
    got, stats = generate_speculative(model, torch.tensor(x), max_new, draft_len=K, eos_token_id=eos,
                                      repetition_penalty=penalty, temperature=temperature, return_stats=True,
                                      cache_len=CACHE_LEN)
    assert torch.equal(got, greedy), (got, greedy)
    ref, ref_stats = jax_speculative(jax_decode(jcfg, CACHE_LEN), params, jnp.asarray(x, jnp.int32), max_new,
                                     draft_len=K, eos_token_id=eos, repetition_penalty=penalty,
                                     temperature=temperature, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert stats == ref_stats


def test_speculative_learned_positions_follow_the_cursor():
    jcfg, params, model = case_pair("learned", "auto-none")
    x = _partly_accepted_prompt(model, 12, 18, 4, 40)
    greedy = generate(model, torch.tensor(x), 18, sampling=SamplingConfig(greedy=True), cache_len=40)
    got, stats = generate_speculative(model, torch.tensor(x), 18, draft_len=4, return_stats=True, cache_len=40)
    assert torch.equal(got, greedy)
    ref = jax_generate(jax_decode(jcfg, 40), params, jnp.asarray(x, jnp.int32), 18, jax.random.PRNGKey(0),
                       JaxSampling(greedy=True))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _call(package, fn, model_of, prompt, max_new, **kw):
    jcfg, params, model = model_of
    cache_len = kw.pop("cache_len", 32)
    if package == "jax":
        jm = jax_decode(jcfg, cache_len)
        x = jnp.asarray(prompt, jnp.int32)
        if fn == "generate":
            return jax_generate(jm, params, x, max_new, jax.random.PRNGKey(0), JaxSampling(greedy=True))
        if fn == "stream":
            return next(jax_stream(jm, params, x, max_new, jax.random.PRNGKey(0), JaxSampling(greedy=True)))
        return jax_speculative(jm, params, x, max_new, **kw)
    x = torch.tensor(prompt)
    if fn == "generate":
        return generate(model, x, max_new, sampling=SamplingConfig(greedy=True), cache_len=cache_len)
    if fn == "stream":
        return next(stream_tokens(model, x, max_new, sampling=SamplingConfig(greedy=True), cache_len=cache_len))
    return generate_speculative(model, x, max_new, cache_len=cache_len, **kw)


# (what, model, function, prompt shape, max_new, kwargs, message)
GUARDS = [
    ("generate_past_cache", "gpt", "generate", (1, 20), 14, {}, "cache_len"),
    ("stream_past_cache", "gpt", "stream", (2, 30), 4, {}, "cache_len"),
    ("generate_learned_past_table", "learned", "generate", (1, 20), 13, dict(cache_len=48), "max_seq_len"),
    ("stream_learned_past_table", "learned", "stream", (1, 30), 3, dict(cache_len=48), "max_seq_len"),
    ("spec_batch", "gpt", "spec", (2, 8), 4, {}, "batch"),
    ("spec_draft_len", "gpt", "spec", (1, 8), 4, dict(draft_len=0), "draft_len"),
    ("spec_temperature", "gpt", "spec", (1, 4), 4, dict(temperature=0.0), "temperature"),
    ("spec_negative_temperature", "gpt", "spec", (1, 4), 4, dict(temperature=-1.0), "temperature"),
    ("spec_penalty", "gpt", "spec", (1, 4), 4, dict(repetition_penalty=0.0), "repetition_penalty"),
    ("spec_past_cache", "gpt", "spec", (1, 16), 9, dict(draft_len=8), "cache_len"),
    ("spec_learned_past_table", "learned", "spec", (1, 20), 13, dict(draft_len=2, cache_len=48), "max_seq_len"),
]


@pytest.fixture(scope="module")
def guard_models():
    return {name: case_pair(name, "auto-none") for name in ("gpt", "learned")}


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("what,name,fn,shape,max_new,kw,match", GUARDS, ids=[g[0] for g in GUARDS])
def test_guards_raise_in_both_packages(guard_models, package, what, name, fn, shape, max_new, kw, match):
    prompt = np.ones(shape, np.int64)
    with pytest.raises(ValueError, match=match):
        _call(package, fn, guard_models[name], prompt, max_new, **dict(kw))
    # one token less (one position less) passes the same guard
    if what.endswith(("past_cache", "past_table")):
        _call(package, fn, guard_models[name], prompt[:, 1:], max_new, **dict(kw))


# ------------------------------------------------------------------ engine

ENGINE_PROMPTS = [_spec_prompt(s, n)[0].tolist() for s, n in ((0, 7), (1, 16), (2, 17), (3, 20))]
CHUNK, PAGE, ENGINE_NEW = 16, 8, 20
# JAX's init as it is: its outputs repeat, so the prompt-lookup drafts are
# accepted often and rejected often (the scaled test weights vary too much
# for any draft to match)
REPETITIVE = 1.0


def _engine(model, draft_k, sampling=SamplingConfig(greedy=True), **kw):
    return ServingEngine(model, n_slots=4, cache_len=CACHE_LEN, sampling=sampling, prefill_chunk=CHUNK,
                         page_size=PAGE, draft_k=draft_k, device="cpu", **kw)


SPEC_KEYS = ("spec_ticks", "draft_tokens", "accepted_tokens", "acceptance_rate", "tokens_out")


@pytest.mark.parametrize("name", ["gpt", "llama"])
@pytest.mark.parametrize("draft_k", [4, 8])
def test_engine_draft_k_greedy_matches_plain_and_jax(name, draft_k):
    jcfg, params, model = case_pair(name, "auto-none", scale=REPETITIVE)
    plain = _engine(model, 0)
    ph = [plain.submit(p, max_new_tokens=ENGINE_NEW) for p in ENGINE_PROMPTS]
    plain.run_until_idle()
    spec = _engine(model, draft_k)
    sh = [spec.submit(p, max_new_tokens=ENGINE_NEW) for p in ENGINE_PROMPTS]
    spec.run_until_idle()
    jeng = JaxEngine(jcfg, params, n_slots=4, cache_len=CACHE_LEN, sampling=JaxSampling(greedy=True),
                     prefill_chunk=CHUNK, kv_layout="paged", page_size=PAGE, draft_k=draft_k)
    jh = [jeng.submit(p, max_new_tokens=ENGINE_NEW) for p in ENGINE_PROMPTS]
    jeng.run_until_idle()
    for a, b, c in zip(ph, sh, jh):
        assert a.status == b.status == c.status == "done"
        assert b.tokens == a.tokens == list(c.tokens)
    snap, ref = spec.metrics_snapshot(), jeng.metrics_snapshot()
    assert {k: snap[k] for k in SPEC_KEYS} == {k: ref[k] for k in SPEC_KEYS}
    assert snap["draft_k"] == draft_k and 0 < snap["acceptance_rate"] < 1, snap
    assert spec.slots.pool.in_use == 0 and spec.slots.pool.reserved == 0


def test_engine_draft_k_validation():
    _, _, model = case_pair("gpt", "auto-none")
    with pytest.raises(ValueError, match="draft_k"):
        _engine(model, -1)
    with pytest.raises(ValueError, match="repetition_penalty"):
        _engine(model, 4, SamplingConfig(greedy=True, repetition_penalty=1.1))
    eng = _engine(model, 8)
    # prompt + max_new fits the cache, the draft window past it does not
    assert eng.submit([1] * 40, max_new_tokens=20).status == "rejected"
    ok = eng.submit([1] * 36, max_new_tokens=20)
    eng.run_until_idle()
    assert ok.status == "done" and len(ok.tokens) == 20


def test_engine_sampled_veto_on_a_fixed_draft():
    """``draft_k`` 1 whose draft is the row's last token: a row that
    rejects it emits one token and carries the draft as its veto, a row
    that accepts it emits two (the second the draft) and carries none, and
    a row's first token after a rejection is never its veto."""
    _, _, model = case_pair("gpt", "auto-none", scale=REPETITIVE)
    eng = _engine(model, 1, SamplingConfig(temperature=1.0, top_k=3), draft_fn=lambda hist, k: [int(hist[-1])] * k)
    handles = [eng.submit(p, max_new_tokens=12, seed=i) for i, p in enumerate(ENGINE_PROMPTS)]
    rejected = accepted = followed = 0
    for _ in range(200):
        if all(h.status == "done" for h in handles):
            break
        active = list(eng._active)
        before = [None if a is None else len(a.handle.tokens) for a in active]
        drafts = [None if a is None else (list(a.handle.request.prompt) + a.handle.tokens)[-1] for a in active]
        veto = eng._veto.tolist()
        eng.step()
        for slot, act in enumerate(active):
            if act is None:
                continue
            new = act.handle.tokens[before[slot]:]
            if veto[slot] >= 0:
                followed += 1
                assert new[0] != veto[slot]
            if act.handle.status == "done":
                continue
            if int(eng._veto[slot]) >= 0:
                rejected += 1
                assert int(eng._veto[slot]) == drafts[slot] and len(new) == 1
            else:
                accepted += 1
                assert new == [new[0], drafts[slot]]
    assert all(h.status == "done" and len(h.tokens) == 12 for h in handles)
    assert rejected and accepted and followed, (rejected, accepted, followed)


def test_engine_sampled_tokens_follow_the_target_distribution():
    """One slot per request, ``draft_k`` 1 with a fixed draft, top-k 3:
    token 1 is sampled, token 2 is either the accepted draft (probability
    p(d | token 1)) or a draw from the residual with the draft vetoed. The
    joint distribution of (token 1, token 2) over 600 seeds is within 0.1
    total variation of the exact p(t1) p(t2 | t1) from the model's logits."""
    _, _, model = make_pair("test", seed=3)
    sampling = SamplingConfig(temperature=1.0, top_k=3)
    prompt = ENGINE_PROMPTS[0]
    with torch.no_grad():
        first = process_logits(model(torch.tensor([prompt]))[:, -1], sampling)[0]
    p1 = torch.softmax(first, -1)
    exact = {}
    with torch.no_grad():
        for t1 in torch.nonzero(p1 > 0).flatten().tolist():
            p2 = torch.softmax(process_logits(model(torch.tensor([prompt + [t1]]))[:, -1], sampling)[0], -1)
            for t2 in torch.nonzero(p2 > 0).flatten().tolist():
                exact[(t1, t2)] = float(p1[t1] * p2[t2])
    draft = max(exact, key=exact.get)[1]  # the likeliest second token: accepted often, rejected often
    n = 600
    eng = _engine(model, 1, sampling, draft_fn=lambda hist, k: [draft] * k, max_queue=n)
    handles = [eng.submit(prompt, max_new_tokens=2, seed=s) for s in range(n)]
    eng.run_until_idle()
    counts = {}
    for h in handles:
        assert h.status == "done" and len(h.tokens) == 2
        counts[tuple(h.tokens)] = counts.get(tuple(h.tokens), 0) + 1
    assert set(counts) <= set(exact), set(counts) - set(exact)
    tv = 0.5 * sum(abs(counts.get(key, 0) / n - p) for key, p in exact.items())
    assert tv < 0.1, (tv, counts, exact)
    snap = eng.metrics_snapshot()
    assert 0 < snap["accepted_tokens"] < snap["draft_tokens"]
