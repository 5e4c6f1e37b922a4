"""The train and eval steps on one device.

Counterpart of ``zero_transformer_tpu/parallel/zero.py``: ``TrainState``,
``make_train_step`` (:194-348) and ``make_eval_step`` (:659) with the
single-device semantics of the JAX step. On one device every ZeRO stage is
the same step: ``zero_stage`` is accepted and recorded, and the sharded
collectives wait for the multi-card slice.

The batch is ``[accum, B, T]`` int tokens. With ``accum > 1`` each
micro-step's grads are summed into a ``grad_accum_dtype`` buffer with
``_accum_add``'s rounding (add in the promoted dtype, round once into the
buffer), then the loss and the grads are divided by ``accum`` in float32.
``grad_norm`` is the norm of the unclipped grads; ``learning_rate`` is the
schedule at the step count before the increment. Updates happen in place.

With a ``SequenceGroup`` (sequence parallelism: each rank runs a shard of
every row through the ring, and its loss is its share of the global mean)
the step sums the grads over the ranks in flat buckets after the
micro-steps, before the clip and AdamW, and sums the logged loss the same
way, so the grad norm, the clip and the update are the same bits on every
rank. ZeRO sharding across processes is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from zero_transformer_tpu_torch.config import resolve_dtype
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.parallel.mesh import SequenceGroup
from zero_transformer_tpu_torch.training.optimizer import AdamW


@dataclasses.dataclass
class TrainState:
    step: int
    model: Transformer
    optimizer: AdamW


def accum_add_(acc: torch.Tensor, g: torch.Tensor) -> None:
    """``acc <- round_into(acc.dtype, acc + g)``, the sum taken in the
    promoted dtype (JAX ``_accum_add``)."""
    ct = torch.promote_types(acc.dtype, g.dtype)
    acc.copy_(acc.to(ct) + g.to(ct))


def make_train_step(
    zero_stage: int = 1,
    schedule: Optional[Callable[[int], float]] = None,
    grad_accum_dtype: str = "float32",
    seq_group: Optional[SequenceGroup] = None,
) -> Callable[[TrainState, torch.Tensor], Dict[str, torch.Tensor]]:
    """``step(state, batch [accum, B, T]) -> metrics``: one optimizer step,
    in place on ``state``. Metrics are 0-d tensors (``loss``, ``grad_norm``)
    and floats (``tokens``, ``learning_rate``): reading the tensors syncs."""
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(f"zero_stage must be 0-3, got {zero_stage}")
    acc_dt = resolve_dtype(grad_accum_dtype)
    if acc_dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grad_accum_dtype must be float32 or bfloat16, got {grad_accum_dtype!r}")

    def micro_grads(model: Transformer, params: List[torch.Tensor], tokens: torch.Tensor):
        _, loss = model(tokens, labels=tokens, train=True)
        return loss.detach(), torch.autograd.grad(loss, params)

    def train_step(state: TrainState, batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        params = state.optimizer.params
        accum = batch.shape[0]
        if accum == 1:
            loss, grads = micro_grads(state.model, params, batch[0])
        else:
            loss = torch.zeros((), dtype=torch.float32, device=batch.device)
            grads = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in params]
            for i in range(accum):
                micro_loss, micro = micro_grads(state.model, params, batch[i])
                loss = loss + micro_loss
                for acc, g in zip(grads, micro):
                    accum_add_(acc, g)
                del micro
            loss = loss / accum
            grads = [g.float() / accum for g in grads]
        if seq_group is not None and seq_group.size > 1:
            grads = list(grads)
            seq_group.all_reduce_(grads)
            loss = seq_group.all_reduce_sum(loss)
        grad_norm = state.optimizer.step(grads)
        metrics = {"loss": loss, "grad_norm": grad_norm, "tokens": float(batch.numel())}
        if schedule is not None:
            metrics["learning_rate"] = schedule(state.step)
        state.step += 1
        return metrics

    return train_step


def make_eval_step(model: Transformer) -> Callable[[torch.Tensor], torch.Tensor]:
    """``eval_step(batch [B, T]) -> mean next-token loss`` (0-d tensor); under
    a sequence group, the ranks' shares summed."""

    @torch.no_grad()
    def eval_step(batch: torch.Tensor) -> torch.Tensor:
        loss = model(batch, labels=batch)[1]
        return loss if model.seq_group is None else model.seq_group.all_reduce_sum(loss)

    return eval_step
