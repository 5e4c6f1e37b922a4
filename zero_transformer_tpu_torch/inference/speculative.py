"""Self-speculative decoding by prompt lookup (no draft model).

Counterpart of ``zero_transformer_tpu/inference/speculative.py``:
``ngram_propose`` (:45, a host function, copied as it is), and
``generate_speculative`` (:233) with its loop (``_spec_loop`` :99) at
batch 1. Each iteration drafts the K tokens that followed the latest earlier
occurrence of the current bigram in the history, runs ONE cached forward
over ``[c0, draft...]`` (K + 1 positions at the cursor) and keeps the drafts
that equal the model's own argmax given the verified prefix, then the
correction token. So the output is plain greedy decoding's, in fewer
forwards on self-similar text.

The loop keeps JAX's carry on the host: the history ``hist`` (every verify
block is written into it whole, rejected drafts included, as JAX's
``dynamic_update_slice`` does, so later drafts read what JAX's read and the
forward count is JAX's), the output and the cursor. The forward runs on the
device (its tokens staged through pinned memory, which does not wait), and
one read per forward (the prefill's: the first token) brings back what
acceptance needs: the
argmaxes with penalty 1.0, or, with any other penalty, the accepted count
and the correction after a walk over the block with the evolving mask of
generated tokens (on the device). The cache cursor then rewinds to ``cur +
n_acc + 1`` (JAX ``_set_cache_index`` :86); the rejected positions past it
keep stale K/V that the validity mask hides until the next forward
overwrites them. Positions, learned ones included, follow the cursor.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from zero_transformer_tpu_torch.inference.generate import _prompt, check_positions, init_cache, prefill, to_device
from zero_transformer_tpu_torch.inference.sampling import apply_repetition_penalty
from zero_transformer_tpu_torch.models.gpt import Transformer


def ngram_propose(history, k: int, n: int = 2, skip: int = 1, window: int = 512):
    """Host-side prompt-lookup draft for the serving tick: the ``k`` tokens
    that followed the most recent earlier occurrence of ``history``'s final
    ``n``-gram, offset by ``skip`` (the tick samples its first token before
    the forward, so the draft bets the match's first token IS that sample
    and proposes what follows it). Prefers the latest match with a full
    ``k``-token continuation, else the longest partial one; pads with zeros
    (no match, short history). The scan covers the trailing ``window``
    positions only."""
    if k < 1:
        return []
    hist = [int(t) for t in history]
    H = len(hist)
    best: list = []
    if H > n:
        key = hist[H - n:]
        floor = max(-1, H - n - 1 - window)
        for start in range(H - n - 1, floor, -1):
            if hist[start:start + n] == key:
                out = hist[start + n + skip:start + n + skip + k]
                if len(out) == k:
                    return out
                if len(out) > len(best):
                    best = out
    return best + [0] * (k - len(best))


def _bigram_draft(hist: List[int], cur: int, K: int) -> List[int]:
    """The K tokens after the latest earlier occurrence of ``(hist[cur - 1],
    hist[cur])`` (a match must end before ``cur``), or ``hist[:K]`` when
    there is none (JAX's start index 0)."""
    prev, c0 = hist[cur - 1], hist[cur]
    start = 0
    for p in range(cur - 2, -1, -1):
        if hist[p] == prev and hist[p + 1] == c0:
            start = p + 2
            break
    return hist[start:start + K]


def _penalized_walk(logits32: torch.Tensor, draft: List[int], gen_mask: torch.Tensor,
                    penalty: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Acceptance under a repetition penalty (JAX's ``acc_step`` scan):
    position j's argmax depends on the tokens accepted before it, so walk
    the block in order with the evolving mask. All on the device; returns
    (n_acc, correction, mask) as tensors."""
    K = len(draft)
    V = logits32.shape[-1]
    dev = logits32.device
    vocab = torch.arange(V, device=dev)
    accepting = torch.ones((), dtype=torch.bool, device=dev)
    n_acc = torch.zeros((), dtype=torch.long, device=dev)
    corr = torch.zeros((), dtype=torch.long, device=dev)
    for j in range(K + 1):
        yj = torch.argmax(apply_repetition_penalty(logits32[j], gen_mask, penalty))
        take = accepting & (yj == draft[j]) if j < K else torch.zeros_like(accepting)
        new_tok = torch.where(take, draft[j] if j < K else 0, yj)
        gen_mask = torch.where(accepting, gen_mask | (vocab == new_tok), gen_mask)
        corr = torch.where(accepting & ~take, yj, corr)
        n_acc = n_acc + take.long()
        accepting = take
    return n_acc, corr, gen_mask


@torch.no_grad()
def generate_speculative(
    model: Transformer,
    prompt,
    max_new_tokens: int,
    *,
    draft_len: int = 8,
    eos_token_id: Optional[int] = None,
    pad_token_id: int = 0,
    repetition_penalty: float = 1.0,
    temperature: float = 1.0,
    return_stats: bool = False,
    cache_len: Optional[int] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, dict]]:
    """Greedy prompt-lookup speculative decode of a [1, T] prompt.

    Returns [1, max_new_tokens] int64, equal to ``generate(...,
    SamplingConfig(greedy=True, repetition_penalty=p, temperature=t))`` by
    construction: the temperature division (float32, as ``process_logits``)
    and the penalty are applied inside acceptance; top-k and top-p never
    change an argmax. ``return_stats`` adds ``{"forwards": n,
    "tokens_per_forward": ...}`` (the prefill counts as a forward).
    ``cache_len`` defaults to ``max_seq_len``."""
    host = torch.as_tensor(prompt, dtype=torch.long)  # the history starts from the prompt on the host
    prompt = _prompt(model, host)
    B, T0 = prompt.shape
    if B != 1:
        raise ValueError("speculative decoding supports batch=1 (serve latency path)")
    K = int(draft_len)
    if K < 1:
        raise ValueError("draft_len must be >= 1")
    if not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if not repetition_penalty > 0:
        raise ValueError(f"repetition_penalty must be > 0, got {repetition_penalty}")
    cfg = model.cfg
    cache_len = cache_len or cfg.max_seq_len
    # the worst case writes K + 1 positions from T0 + max_new - 1
    if T0 + max_new_tokens + K > cache_len:
        raise ValueError(
            f"prompt ({T0}) + max_new_tokens ({max_new_tokens}) + draft_len ({K}) exceeds cache_len ({cache_len})"
        )
    check_positions(cfg, T0, max_new_tokens)
    eos = -1 if eos_token_id is None else int(eos_token_id)
    cache = init_cache(model, 1, cache_len)
    last = prefill(model, prompt, cache)
    # the first token: nothing generated yet, so no penalty applies
    c0 = int(torch.argmax(last[0].float() / temperature))
    # JAX's arange(V) == c0: an indexed write of a host scalar would copy it to the card and wait
    gen_mask = torch.arange(last.shape[-1], device=last.device) == c0

    hist = host.reshape(-1).tolist() + [0] * (max_new_tokens + K + 2)
    hist[T0] = c0
    out = [c0]
    done = c0 == eos
    cur, n_fwd = T0, 0
    while len(out) < max_new_tokens and not done:
        draft = _bigram_draft(hist, cur, K)
        cache.index = cur
        x = to_device([[hist[cur]] + draft], prompt.device)
        logits32 = model.logits(cache.forward(model, x)[0]).float() / temperature  # [K + 1, V]
        if repetition_penalty == 1.0:
            y = torch.argmax(logits32, dim=-1).tolist()
            n_acc = 0
            while n_acc < K and draft[n_acc] == y[n_acc]:
                n_acc += 1
            # JAX's block: the drafts and the last argmax, the correction at n_acc
            block = draft + [y[K]]
            block[n_acc] = y[n_acc]
        else:
            n_acc_t, corr_t, gen_mask = _penalized_walk(logits32, draft, gen_mask, repetition_penalty)
            n_acc, corr = torch.stack([n_acc_t, corr_t]).tolist()
            block = draft + [corr]
            block[n_acc] = corr
        n_emit = n_acc + 1
        if eos in block[:n_emit]:
            n_emit = block.index(eos) + 1
            done = True
        out += block[:n_emit]
        hist[cur + 1:cur + K + 2] = block
        cache.index = cur + n_acc + 1
        cur += n_emit
        n_fwd += 1
    n_emitted = min(len(out), max_new_tokens)
    out = out[:max_new_tokens]
    if eos in out:  # past an early EOS, pad (generate's contract)
        out = out[:out.index(eos) + 1]
    out += [pad_token_id] * (max_new_tokens - len(out))
    tokens = to_device([out], prompt.device)
    if return_stats:
        return tokens, {"forwards": n_fwd + 1, "tokens_per_forward": n_emitted / (n_fwd + 1)}
    return tokens
