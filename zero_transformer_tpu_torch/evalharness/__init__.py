"""Eval harness: log-likelihood scoring and the tasks built on it.

Counterpart of ``zero_transformer_tpu/evalharness/``: ``score_batch`` and
``loglikelihoods`` (``scoring.py``), ``lambada``, ``choice_accuracy`` and
``perplexity`` (``tasks.py``), and the CLI ``python -m
zero_transformer_tpu_torch.evalharness`` (``cli.py``). The JAX functions
take ``(model, params, ...)``; here the model carries its weights, so every
function takes the model alone."""
from zero_transformer_tpu_torch.evalharness.scoring import loglikelihoods, score_batch
from zero_transformer_tpu_torch.evalharness.tasks import choice_accuracy, lambada, perplexity

__all__ = ["choice_accuracy", "lambada", "loglikelihoods", "perplexity", "score_batch"]
