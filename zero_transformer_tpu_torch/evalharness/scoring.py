"""Log-likelihood scoring primitives (counterpart of
``zero_transformer_tpu/evalharness/scoring.py``).

lm-eval-harness "loglikelihood" semantics: an example is (context tokens,
continuation tokens); its score is the sum of log P(continuation_t |
context, continuation_<t); "greedy match" means every continuation token is
the argmax. Batches are right-padded with token 0 to ``[batch, seq_len]``,
as in JAX; for the byte models 0 is also the document separator, so each
pad token is a document of its own and the scored rows attend to nothing
past their end either way.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from zero_transformer_tpu_torch.models.gpt import Transformer


@torch.no_grad()
def score_batch(model: Transformer, tokens: torch.Tensor, target_mask: torch.Tensor) -> dict:
    """Score the target positions of a ``[B, T]`` batch on the model's device.

    ``target_mask`` ``[B, T]`` marks the positions whose tokens are
    predicted (the continuation); position t is predicted from the logits at
    t - 1. Returns per-example ``logprob`` (f32 sum), ``tokens`` and
    ``greedy_match``; the softmax runs in float32."""
    logits = model(tokens)
    logp = torch.log_softmax(logits.float(), dim=-1)
    pred_logp = logp[:, :-1, :]
    targets = tokens[:, 1:].long()
    mask = target_mask[:, 1:].float()
    tok_logp = torch.gather(pred_logp, -1, targets[..., None])[..., 0]
    greedy = (pred_logp.argmax(-1) == targets).float()
    return {
        "logprob": torch.sum(tok_logp * mask, dim=-1),
        "tokens": torch.sum(mask, dim=-1),
        "greedy_match": torch.all(torch.where(mask > 0, greedy, 1.0) > 0, dim=-1),
    }


def _pad_batch(
    examples: Sequence[Tuple[Sequence[int], Sequence[int]]], seq_len: int, batch: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Right-pad (context, continuation) pairs to ``[batch, seq_len]``.
    Long contexts are cut from the left (the continuation stays whole), the
    sliding-window convention of lm-eval-harness."""
    tokens = np.zeros((batch, seq_len), np.int32)
    mask = np.zeros((batch, seq_len), np.int32)
    valid = np.zeros((batch,), np.int32)
    for i, (ctx, cont) in enumerate(examples):
        ctx, cont = list(ctx), list(cont)
        if not cont:
            raise ValueError("empty continuation")
        if len(cont) >= seq_len:
            raise ValueError(f"continuation ({len(cont)}) must be < seq_len ({seq_len})")
        keep_ctx = min(len(ctx), seq_len - len(cont))
        if keep_ctx < 1:
            raise ValueError("need at least one context token")
        row = ctx[len(ctx) - keep_ctx:] + cont
        tokens[i, : len(row)] = row
        mask[i, keep_ctx: len(row)] = 1
        valid[i] = 1
    return tokens, mask, valid


def model_device(model: Transformer) -> torch.device:
    return next(model.parameters()).device


def loglikelihoods(
    model: Transformer, examples: Iterable[Tuple[Sequence[int], Sequence[int]]],
    seq_len: int, batch_size: int = 8,
) -> List[dict]:
    """Score every (context, continuation) pair; one dict per example with
    ``logprob``, ``tokens`` and ``greedy_match``."""
    examples = list(examples)
    dev = model_device(model)
    out: List[dict] = []
    for start in range(0, len(examples), batch_size):
        chunk = examples[start:start + batch_size]
        padded = chunk + [([0], [0])] * (batch_size - len(chunk))  # dummy rows, dropped below
        tokens, mask, _ = _pad_batch(padded, seq_len, batch_size)
        res = score_batch(model, torch.from_numpy(tokens).to(dev), torch.from_numpy(mask).to(dev))
        logprob, n_tok, greedy = (res[k].cpu().tolist() for k in ("logprob", "tokens", "greedy_match"))
        for i in range(len(chunk)):
            out.append({"logprob": float(logprob[i]), "tokens": int(n_tok[i]),
                        "greedy_match": bool(greedy[i])})
    return out
