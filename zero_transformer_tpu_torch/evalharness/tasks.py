"""Evaluation tasks (counterpart of
``zero_transformer_tpu/evalharness/tasks.py``): LAMBADA-style last-word
prediction, multiple-choice accuracy, token-stream perplexity and
bits-per-byte. Inputs are token sequences: tokenization happens upstream."""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from zero_transformer_tpu_torch.evalharness.scoring import loglikelihoods, model_device, score_batch
from zero_transformer_tpu_torch.models.gpt import Transformer


def lambada(
    model: Transformer, examples: Iterable[Tuple[Sequence[int], Sequence[int]]],
    seq_len: int, batch_size: int = 8,
) -> dict:
    """(context, last-word tokens) pairs -> ``{"ppl", "acc", "examples"}``:
    perplexity over the target tokens and greedy-prediction accuracy."""
    results = loglikelihoods(model, examples, seq_len, batch_size)
    if not results:
        return {"ppl": float("nan"), "acc": float("nan"), "examples": 0}
    total_lp = sum(r["logprob"] for r in results)
    total_tok = sum(r["tokens"] for r in results)
    acc = sum(r["greedy_match"] for r in results) / len(results)
    return {"ppl": math.exp(-total_lp / max(total_tok, 1)), "acc": acc, "examples": len(results)}


def choice_accuracy(
    model: Transformer, examples: Iterable[tuple], seq_len: int, batch_size: int = 8,
) -> dict:
    """Multiple choice. Each example is ``(context, choices, gold)`` or
    ``(context, choices, gold, choice_byte_lens)``; every choice is scored as
    sum log P(choice | context), and the prediction is the argmax under the
    raw sum (``acc``) and under the sum per byte (``acc_norm``; per token
    when no byte lengths are given, reported as ``norm="tokens"``)."""
    examples = list(examples)
    flat: List[Tuple[Sequence[int], Sequence[int]]] = []
    spans: List[Tuple[int, int]] = []  # [start, end) into flat per example
    for ex in examples:
        ctx, choices = ex[0], ex[1]
        if not choices:
            raise ValueError("example has no choices")
        spans.append((len(flat), len(flat) + len(choices)))
        flat.extend((ctx, cont) for cont in choices)
    # one normalization per run: mixing per-byte and per-token across
    # examples would make acc_norm a hybrid
    has_bytes = [len(ex) > 3 and ex[3] is not None for ex in examples]
    if any(has_bytes) and not all(has_bytes):
        raise ValueError(
            f"choice_byte_lens must be provided for all examples or none "
            f"(got {sum(has_bytes)}/{len(examples)})"
        )
    used_bytes = bool(examples) and all(has_bytes)
    scored = loglikelihoods(model, flat, seq_len, batch_size)

    n_correct, n_correct_norm = 0, 0
    for ex, (start, end) in zip(examples, spans):
        gold = int(ex[2])
        lps = [scored[i]["logprob"] for i in range(start, end)]
        byte_lens = ex[3] if used_bytes else [max(scored[i]["tokens"], 1) for i in range(start, end)]
        if len(byte_lens) != len(lps):
            raise ValueError("choice_byte_lens length mismatch")
        n_correct += int(int(np.argmax(lps)) == gold)
        normed = [lp / max(b, 1) for lp, b in zip(lps, byte_lens)]
        n_correct_norm += int(int(np.argmax(normed)) == gold)
    n = max(len(examples), 1)
    return {"acc": n_correct / n, "acc_norm": n_correct_norm / n,
            "norm": "bytes" if used_bytes else "tokens", "examples": len(examples)}


def perplexity(
    model: Transformer, tokens: Sequence[int], seq_len: int, batch_size: int = 8,
    num_bytes: Optional[int] = None,
) -> dict:
    """Token-stream perplexity over ``seq_len`` windows with one token of
    overlap (stride ``seq_len - 1``), so every token but the stream's first
    is predicted exactly once (lm-eval-harness's rolling log-likelihood).
    With ``num_bytes`` (the UTF-8 length of the source text) it also reports
    bits-per-byte, nll_total / (ln 2 * bytes)."""
    tokens = np.asarray(tokens, np.int32)
    if len(tokens) < 2:
        raise ValueError(f"need at least 2 tokens, got {len(tokens)}")
    stride = seq_len - 1
    n_windows = (len(tokens) - 2) // stride + 1
    # pad the tail once so every window is a strided view; the pad is masked
    padded = np.zeros(n_windows * stride + 1, np.int32)
    padded[: len(tokens)] = tokens
    windows = np.lib.stride_tricks.sliding_window_view(padded, seq_len)[::stride]
    # every window predicts positions 1.., except past the real tail of the last
    window_masks = np.zeros((n_windows, seq_len), np.int32)
    window_masks[:, 1:] = 1
    tail = len(tokens) - (n_windows - 1) * stride
    window_masks[-1, tail:] = 0

    dev = model_device(model)
    total_nll, total_tok = 0.0, 0
    for start in range(0, n_windows, batch_size):
        chunk = windows[start:start + batch_size]
        mask = window_masks[start:start + batch_size]
        n_real = len(chunk)
        pad_n = batch_size - n_real
        if pad_n:
            chunk = np.concatenate([chunk, np.zeros((pad_n, seq_len), np.int32)])
            mask = np.concatenate([mask, np.zeros((pad_n, seq_len), np.int32)])
        res = score_batch(model, torch.from_numpy(np.ascontiguousarray(chunk)).to(dev),
                          torch.from_numpy(mask).to(dev))
        total_nll += -float(torch.sum(res["logprob"][:n_real]))
        total_tok += int(torch.sum(res["tokens"][:n_real]))

    out = {"nll": total_nll, "tokens": total_tok, "ppl": math.exp(total_nll / max(total_tok, 1))}
    if num_bytes:
        out["bits_per_byte"] = total_nll / (math.log(2) * num_bytes)
    return out
