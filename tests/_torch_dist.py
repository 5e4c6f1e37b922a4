"""Multi-process helpers of the port's sequence-parallel tests (no test here).

``run_world`` starts one world of gloo processes (``torch.multiprocessing``,
spawn) that rendezvous through ``file://`` in the test's tmp directory, so
xdist workers never share a port; each rank runs one of the rank bodies
below on the payload and saves what it returns; the world is joined under
a deadline, so a hung collective fails the test instead of stalling the
suite. The rank bodies import torch and the port only, never JAX.
"""
from __future__ import annotations

import importlib
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

DEADLINE_S = 120.0


def _entry(rank, world, init_file, body, payload_path, out_dir):
    torch.set_num_threads(1)
    from zero_transformer_tpu_torch.parallel.mesh import destroy, init_distributed

    group = init_distributed(world, "gloo", "cpu", rank=rank, world_size=world,
                             init_method=f"file://{init_file}")
    try:
        payload = torch.load(payload_path, weights_only=False)
        result = getattr(importlib.import_module(__name__), body)(group, payload)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        destroy(group)


def run_world(body: str, payload, tmp_path: Path, world: int = 4, deadline: float = DEADLINE_S) -> list:
    """Run ``body(group, payload)`` on ``world`` gloo ranks; returns each
    rank's result, in rank order."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    payload_path = tmp_path / "payload.pt"
    torch.save(payload, payload_path)
    ctx = mp.start_processes(_entry, args=(world, str(tmp_path / "rendezvous"), body, str(payload_path),
                                           str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
            if time.monotonic() >= end:
                raise TimeoutError(f"the {world}-rank world did not finish within {deadline} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def shard(x: np.ndarray, rank: int, world: int, dim: int = 1) -> np.ndarray:
    t = x.shape[dim] // world
    return np.take(x, np.arange(rank * t, (rank + 1) * t), axis=dim)


# ---------------------------------------------------------------- rank bodies


def ring_cases(group, cases: dict) -> dict:
    """``ring_attention`` forward and backward of every case on this rank's
    shards: {case: (out, dq, dk, dv)} as numpy."""
    from zero_transformer_tpu_torch.ops.ring_attention import ring_attention

    out = {}
    for name, c in cases.items():
        q, k, v = (torch.from_numpy(shard(c[x], group.rank, group.size)).requires_grad_() for x in "qkv")
        ids = None if c["ids"] is None else torch.from_numpy(shard(c["ids"], group.rank, group.size))
        o = ring_attention(q, k, v, group, causal=True, alibi=c["alibi"], doc_ids=ids)
        grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(shard(c["g"], group.rank, group.size)))
        out[name] = tuple(x.detach().numpy() for x in (o, *grads))
    return out


def train_cases(group, cases: dict) -> dict:
    """Three optimizer steps of every case's model on the ring: {case:
    (losses, grad norms, final params by name)}."""
    from zero_transformer_tpu_torch import config as tconfig
    from zero_transformer_tpu_torch.models.gpt import Transformer
    from zero_transformer_tpu_torch.parallel.zero import TrainState, make_train_step
    from zero_transformer_tpu_torch.training.optimizer import make_optimizer, make_schedule

    out = {}
    for name, c in cases.items():
        cfg = tconfig.model_config("test", **c["model"])
        model = Transformer(cfg, device="cpu", seq_group=group)
        model.load_state_dict({n: torch.from_numpy(p) for n, p in c["params"].items()})
        model.requires_grad_(True)
        opt_cfg = tconfig.OptimizerConfig(**c["opt"])
        schedule = make_schedule(opt_cfg)
        state = TrainState(step=0, model=model, optimizer=make_optimizer(model, opt_cfg, schedule))
        step = make_train_step(1, schedule, seq_group=group)
        losses, norms = [], []
        for batch in c["batches"]:
            m = step(state, torch.from_numpy(batch))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = (losses, norms, {n: p.detach().numpy() for n, p in model.named_parameters()})
    return out
