"""Multi-process helpers of the port's multi-process tests (no test here).

``run_world`` starts one world of gloo processes (``torch.multiprocessing``,
spawn) that rendezvous through ``file://`` in the test's tmp directory, so
xdist workers never share a port; each rank runs one of the rank bodies
below on the payload and saves what it returns; the world is joined under
a deadline, so a hung collective fails the test instead of stalling the
suite. The rank bodies import torch and the port only, never JAX.
"""
from __future__ import annotations

import importlib
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

DEADLINE_S = 120.0


def _entry(rank, world, init_file, body, payload_path, out_dir, sequence, tensor):
    torch.set_num_threads(1)
    from zero_transformer_tpu_torch.parallel.mesh import destroy, init_distributed

    mesh = init_distributed(sequence, "gloo", "cpu", tensor=tensor, rank=rank, world_size=world,
                            init_method=f"file://{init_file}")
    try:
        payload = torch.load(payload_path, weights_only=False)
        result = getattr(importlib.import_module(__name__), body)(mesh, payload)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        destroy(mesh)


def run_world(body: str, payload, tmp_path: Path, world: int = 4, deadline: float = DEADLINE_S,
              sequence: int = None, tensor: int = 1) -> list:
    """Run ``body(mesh, payload)`` on ``world`` gloo ranks of a ``data x
    tensor x sequence`` mesh (``sequence`` None: all the ranks a tensor
    group leaves in one sequence group); returns each rank's result, in
    rank order."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    payload_path = tmp_path / "payload.pt"
    torch.save(payload, payload_path)
    ctx = mp.start_processes(_entry, args=(world, str(tmp_path / "rendezvous"), body, str(payload_path),
                                           str(tmp_path), world // tensor if sequence is None else sequence,
                                           tensor),
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


def ring_cases(mesh, cases: dict) -> dict:
    """``ring_attention`` forward and backward of every case on this rank's
    shards: {case: (out, dq, dk, dv)} as numpy."""
    from zero_transformer_tpu_torch.ops.ring_attention import ring_attention

    group = mesh.sequence
    out = {}
    for name, c in cases.items():
        q, k, v = (torch.from_numpy(shard(c[x], group.rank, group.size)).requires_grad_() for x in "qkv")
        ids = None if c["ids"] is None else torch.from_numpy(shard(c["ids"], group.rank, group.size))
        o = ring_attention(q, k, v, group, causal=True, alibi=c["alibi"], doc_ids=ids)
        grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(shard(c["g"], group.rank, group.size)))
        out[name] = tuple(x.detach().numpy() for x in (o, *grads))
    return out


def train_cases(mesh, cases: dict) -> dict:
    """Three optimizer steps of every case's model on the ring: {case:
    (losses, grad norms, final params by name)}."""
    group = mesh.sequence
    from zero_transformer_tpu_torch import config as tconfig
    from zero_transformer_tpu_torch.models.gpt import Transformer
    from zero_transformer_tpu_torch.parallel.zero import init_train_state, make_train_step
    from zero_transformer_tpu_torch.training.optimizer import make_schedule

    out = {}
    for name, c in cases.items():
        cfg = tconfig.model_config("test", **c["model"])
        model = Transformer(cfg, device="cpu", seq_group=group)
        model.load_state_dict({n: torch.from_numpy(p) for n, p in c["params"].items()})
        model.requires_grad_(True)
        opt_cfg = tconfig.OptimizerConfig(**c["opt"])
        schedule = make_schedule(opt_cfg)
        state = init_train_state(model, opt_cfg, schedule)
        step = make_train_step(1, schedule, seq_group=group)
        losses, norms = [], []
        for batch in c["batches"]:
            m = step(state, torch.from_numpy(batch))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = (losses, norms, {n: p.detach().numpy() for n, p in model.named_parameters()})
    return out


def shard_loss_cases(mesh, c: dict) -> dict:
    """This rank's share of the loss and its grads on the sequence ring,
    with ``loss_chunk`` and without: {case: (chunked, whole)}, each a dict
    of the loss, the logits' shape (None when the loss is chunked) and the
    grads by name."""
    from zero_transformer_tpu_torch import config as tconfig
    from zero_transformer_tpu_torch.models.gpt import Transformer

    out = {}
    for case, tokens in c["tokens"].items():
        runs = []
        for chunk in (c["chunk"], None):
            cfg = tconfig.model_config("test", dropout=0.0, compute_dtype="float32", loss_chunk=chunk,
                                       doc_sep_token=0 if case == "packed" else None)
            model = Transformer(cfg, device="cpu", seq_group=mesh.sequence)
            model.load_state_dict({n: torch.from_numpy(p) for n, p in c["params"].items()})
            model.requires_grad_(True)
            t = torch.from_numpy(tokens)
            logits, loss = model(t, labels=t, train=True)
            grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
            runs.append({"loss": loss.item(), "logits": None if logits is None else tuple(logits.shape),
                         "grads": {n: g.numpy() for (n, _), g in zip(model.named_parameters(), grads)}})
        out[case] = tuple(runs)
    return out


def zero_cases(mesh, cases: dict) -> dict:
    """Three ZeRO optimizer steps of every case's model on this rank's rows
    of each global batch: {case: dict(losses, grad norms, whole params by
    name, persistent bytes, replica audit)}. A case's ``data x sequence``
    other than the world's own mesh gets a mesh of its own."""
    from zero_transformer_tpu_torch import config as tconfig
    from zero_transformer_tpu_torch.models.gpt import Transformer
    from zero_transformer_tpu_torch.parallel.mesh import make_mesh
    from zero_transformer_tpu_torch.parallel.zero import init_train_state, make_replica_audit, make_train_step
    from zero_transformer_tpu_torch.training.optimizer import make_schedule

    out = {}
    for name, c in cases.items():
        m = mesh if (c["data"], c["sequence"]) == (mesh.data.size, mesh.sequence.size) else \
            make_mesh(c["data"], 1, c["sequence"], "gloo", mesh.device)
        model = Transformer(tconfig.model_config(c.get("zoo", "test"), **c["model"]), device="cpu")
        model.load_state_dict({n: torch.from_numpy(p) for n, p in c["params"].items()})
        model.requires_grad_(True).set_sequence_group(m.sequence)
        opt_cfg = tconfig.OptimizerConfig(**c["opt"])
        schedule = make_schedule(opt_cfg)
        state = init_train_state(model, opt_cfg, schedule, m.data, c["stage"])
        step = make_train_step(c["stage"], schedule, c["accum_dtype"], m.sequence)
        rows = c["batches"][0].shape[1] // m.data.size
        lo = m.data.rank * rows
        losses, norms, tokens = [], [], []
        for batch in c["batches"]:
            metrics = step(state, torch.from_numpy(batch[:, lo:lo + rows]))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            tokens.append(metrics["tokens"])
        leaves = state.shards.state_leaves()
        audit = make_replica_audit(state.shards)
        out[name] = dict(losses=losses, norms=norms, tokens=tokens,
                         params={k.removeprefix("params/"): v.numpy().copy()
                                 for k, v in leaves.items() if k.startswith("params/")},
                         persistent_bytes=state.shards.persistent_bytes(),
                         diverged=None if audit is None else audit())
    return out


def ring_loss_grads(mesh, cases: dict) -> dict:
    """Every case's model (``zoo`` with ``model`` overrides) on a ring of
    all the world's ranks: this rank's share of the loss and its grads by
    name, for the full rows ``tokens``."""
    from zero_transformer_tpu_torch import config as tconfig
    from zero_transformer_tpu_torch.models.gpt import Transformer
    from zero_transformer_tpu_torch.parallel.mesh import make_mesh

    ring = make_mesh(1, 1, mesh.world_size, "gloo", mesh.device).sequence
    out = {}
    for name, c in cases.items():
        model = Transformer(tconfig.model_config(c["zoo"], **c["model"]), device="cpu", seq_group=ring)
        model.load_state_dict({n: torch.from_numpy(p) for n, p in c["params"].items()})
        model.requires_grad_(True)
        t = torch.from_numpy(c["tokens"])
        _, loss = model(t, labels=t, train=True)
        grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
        out[name] = (loss.item(), {n: g.numpy() for (n, _), g in zip(model.named_parameters(), grads)})
    return out


def llama_world(mesh, payload: dict) -> dict:
    """The Llama file's one world: ``zero_cases`` and ``ring_loss_grads``."""
    return {"zero": zero_cases(mesh, payload["zero"]), "ring": ring_loss_grads(mesh, payload["ring"])}


def trainer_run(mesh, c: dict) -> dict:
    """The trainer on this world's mesh: ``c["overrides"]`` on
    configs/train_test.yaml, ``train(max_steps)``; rank 0 returns its
    metrics by step, every rank its whole params digest."""
    from zero_transformer_tpu_torch import config as tconfig
    from zero_transformer_tpu_torch.training.trainer import Trainer

    cfg = tconfig.apply_dotted_overrides(tconfig.load_config(c["config"]), c["overrides"])
    trainer = Trainer(cfg, device="cpu", mesh=mesh)
    try:
        trainer.train(max_steps=c.get("max_steps"))
        leaves = trainer.state.shards.state_leaves()
    finally:
        trainer.close()
    out = {"step": trainer.state.step,
           "params": {k.removeprefix("params/"): v.numpy().copy() for k, v in leaves.items()
                      if k.startswith("params/")}}
    if mesh.rank == 0:
        lines = (Path(cfg.checkpoint.directory) / "metrics.jsonl").read_text().splitlines()
        out["metrics"] = [json.loads(x) for x in lines]
    return out


def _data_tensor_sequence(data: int, sequence: int, tensor: int = 1) -> tuple:
    """A run's ``mesh`` entry, ``(data, sequence[, tensor])``, in
    ``make_mesh``'s order."""
    return data, tensor, sequence


def trainer_runs(mesh, runs: list) -> list:
    """``trainer_run`` for each run in order, on the world's mesh or on a
    ``data x sequence`` (or ``data x sequence x tensor``) mesh of its own; a run may first have rank 0 copy a
    run directory (``copy``: [(source, destination), ...])."""
    import shutil

    from zero_transformer_tpu_torch.parallel.mesh import make_mesh

    out = []
    for run in runs:
        if mesh.rank == 0:
            for src, dst in run.get("copy", ()):
                shutil.copytree(src, dst)
        mesh.barrier()
        m = mesh if "mesh" not in run else make_mesh(*_data_tensor_sequence(*run["mesh"]), "gloo", mesh.device)
        out.append(trainer_run(m, run))
    return out


def guarded_zero_steps(mesh, c: dict) -> dict:
    """ZeRO steps under the anomaly guard on this rank's rows; on rank
    ``nan_rank`` the loss of micro-batch ``nan_micro`` of step ``nan_step``
    is scaled by NaN in the forward (its grads go NaN too). Returns the
    flags, the optimizer count, the carry and the whole params."""
    from zero_transformer_tpu_torch import config as tconfig
    from zero_transformer_tpu_torch.models.gpt import Transformer
    from zero_transformer_tpu_torch.parallel.zero import init_train_state, make_train_step
    from zero_transformer_tpu_torch.resilience.anomaly import AnomalyGuard
    from zero_transformer_tpu_torch.training.optimizer import make_schedule

    model = Transformer(tconfig.model_config("test", **c["model"]), device="cpu")
    model.load_state_dict({n: torch.from_numpy(p) for n, p in c["params"].items()})
    model.requires_grad_(True)
    opt_cfg = tconfig.OptimizerConfig(**c["opt"])
    schedule = make_schedule(opt_cfg)
    state = init_train_state(model, opt_cfg, schedule, mesh.data, c["stage"])
    guard = AnomalyGuard(tconfig.ResilienceConfig(anomaly_response="skip_batch"), "cpu")
    step = make_train_step(c["stage"], schedule, guard=guard)

    def poison(module, args, kwargs, output):
        _, step_no, rank, micro = kwargs["dropout_key"]
        if (rank, step_no, micro) == (c["nan_rank"], c["nan_step"], c["nan_micro"]):
            return output[0], output[1] * float("nan")
        return output

    model.register_forward_hook(poison, with_kwargs=True)
    rows = c["batches"][0].shape[1] // mesh.data.size
    lo = mesh.data.rank * rows
    flags = []
    for batch in c["batches"]:
        flags.append(bool(step(state, torch.from_numpy(batch[:, lo:lo + rows]))["anomaly"]))
    leaves = state.shards.state_leaves()
    stats = guard.read()
    return {"anomaly": flags, "count": int(state.optimizer.count),
            "carry": (stats.count, stats.streak, stats.loss_ema, stats.grad_ema),
            "params": {k.removeprefix("params/"): v.numpy().copy() for k, v in leaves.items()
                       if k.startswith("params/")}}


def trainer_chaos_runs(mesh, runs: list) -> list:
    """The trainer for each run in order on the world's mesh, with a
    ``replica_perturb`` fault at step ``perturb`` where given; the steps
    its replica audit ran after (None without an audit), the halt's text,
    the resilience report and the whole params."""
    from zero_transformer_tpu_torch import config as tconfig
    from zero_transformer_tpu_torch.resilience import AnomalyHalt
    from zero_transformer_tpu_torch.resilience.chaos import ChaosMonkey, Fault
    from zero_transformer_tpu_torch.training.trainer import Trainer

    out = []
    for run in runs:
        cfg = tconfig.apply_dotted_overrides(tconfig.load_config(run["config"]), run["overrides"])
        chaos = ChaosMonkey([Fault("replica_perturb", run["perturb"])]) if run.get("perturb") else None
        trainer = Trainer(cfg, device="cpu", mesh=mesh, chaos=chaos)
        audit_steps = None
        if trainer.audit is not None:
            audit_steps, audit = [], trainer.audit

            def recorded(audit=audit, steps=audit_steps):
                steps.append(trainer.state.step)
                return audit()

            trainer.audit = recorded
        error = None
        try:
            trainer.train()
        except AnomalyHalt as e:
            error = str(e)
        finally:
            trainer.close()
        leaves = trainer.state.shards.state_leaves()
        out.append({"name": run["name"], "step": trainer.state.step, "audit_steps": audit_steps, "error": error,
                    "report": dict(trainer.resilience_report),
                    "params": {k.removeprefix("params/"): v.numpy().copy() for k, v in leaves.items()
                               if k.startswith("params/")}})
        mesh.barrier()
    return out


# ------------------------------------------------- tensor parallelism, Ulysses


def _tensor_group(mesh):
    """The whole world as one tensor group (a pure tensor-parallel mesh)."""
    from zero_transformer_tpu_torch.parallel.mesh import tensor_group_of_world

    return tensor_group_of_world("gloo", mesh.device)


def _tp_model(c: dict, group):
    """The case's model over ``group``, this rank's shard of its whole
    ``state`` loaded, cast for inference."""
    from zero_transformer_tpu_torch import config as tconfig
    from zero_transformer_tpu_torch.inference import shard_for_inference
    from zero_transformer_tpu_torch.models.gpt import Transformer

    model = Transformer(tconfig.model_config(c["zoo"], **c["over"]), device="cpu", tensor_group=group)
    model.load_state_dict(shard_for_inference(model, {n: torch.from_numpy(p) for n, p in c["state"].items()},
                                              group))
    return model.cast_for_inference()


def _scattered(c: dict, group) -> dict:
    """``scatter_for_inference`` from rank 0's whole state: whether the
    rank's weights equal its ``shard_for_inference`` slices, and the error
    every rank raises when rank 0's tree lacks a name."""
    from zero_transformer_tpu_torch import config as tconfig
    from zero_transformer_tpu_torch.inference import scatter_for_inference, shard_for_inference
    from zero_transformer_tpu_torch.models.gpt import Transformer

    whole = {n: torch.from_numpy(p) for n, p in c["state"].items()}
    model = Transformer(tconfig.model_config(c["zoo"], **c["over"]), device="cpu", tensor_group=group)
    scatter_for_inference(model, whole if group.rank == 0 else None, group)
    want = shard_for_inference(model, whole, group)
    equal = sorted(model.state_dict()) == sorted(want) and all(
        torch.equal(t, want[n]) for n, t in model.state_dict().items())
    try:
        scatter_for_inference(model, dict(list(whole.items())[1:]) if group.rank == 0 else None, group)
        error = None
    except RuntimeError as exc:
        error = str(exc)
    return dict(scattered_equal=equal, short_tree_error=error)


def tp_generate_cases(mesh, cases: dict) -> dict:
    """Every case's model split over the world: greedy ``generate`` tokens,
    the prefill's last logits over a fresh cache, the cache's kv heads, the
    rank's state shapes and its weights scattered from rank 0."""
    from zero_transformer_tpu_torch.inference import SamplingConfig, generate, init_cache, prefill

    group = _tensor_group(mesh)
    out = {}
    for name, c in cases.items():
        model = _tp_model(c, group)
        prompt = torch.from_numpy(c["prompt"])
        tokens = generate(model, prompt, c["new"], sampling=SamplingConfig(greedy=True), cache_len=c["cache_len"])
        cache = init_cache(model, prompt.shape[0], c["cache_len"])
        with torch.no_grad():
            logits = prefill(model, prompt, cache)
        out[name] = dict(tokens=tokens.numpy(), logits=logits.numpy(), pool=tuple(cache.pools[0].k.shape),
                         shapes={n: tuple(t.shape) for n, t in model.state_dict().items()}, **_scattered(c, group))
    return out


def tp_engine_cases(mesh, cases: dict) -> dict:
    """Every case's serving engine split over the world: rank 0 submits each
    wave of prompts and runs it to idle (so a later wave can hit the prefix
    cache), then stops the others, which follow its plans in
    ``serve_worker``. Rank 0 returns the streams and counters."""
    from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
    from zero_transformer_tpu_torch.serving import ServingEngine

    from zero_transformer_tpu_torch.serving import ServeFault, ServingChaosMonkey

    group = _tensor_group(mesh)
    out = {}
    for name, c in cases.items():
        chaos = ServingChaosMonkey([ServeFault(**c["fault"])]) if c.get("fault") else None
        engine = ServingEngine(_tp_model(c, group), device="cpu", sampling=SamplingConfig(greedy=True), chaos=chaos,
                               **c["engine"])
        if c.get("cow"):  # every rank's pools filled alike, then rank 0's copy-on-write of page 3 into page 5
            gen = torch.Generator().manual_seed(group.rank)
            for layer in engine.pools:
                for pool in (layer.k, layer.v, layer.k_scale, layer.v_scale):
                    if pool is not None:
                        pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen).to(pool.dtype))
        if group.rank:
            engine.serve_worker()
            out[name] = dict(kv_pool_bytes=engine.kv_pool_bytes, weight_bytes=engine.weight_bytes)
        else:
            if c.get("cow"):
                engine._copy_page(3, 5)
            streams, outcomes = [], []
            for i, wave in enumerate(c["waves"]):
                if i and c.get("reload"):  # the second wave on the reloaded weights
                    engine.reload_params({n: torch.from_numpy(v) for n, v in c["reload"].items()})
                handles = [engine.submit(list(p), max_new_tokens=c["new"]) for p in wave]
                engine.run_until_idle()
                streams += [h.tokens for h in handles]
                outcomes += [(h.status, h.retryable) for h in handles]
            engine.shutdown_workers()
            snap = engine.metrics_snapshot()
            out[name] = dict(streams=streams, outcomes=outcomes, kv_pool_bytes=engine.kv_pool_bytes,
                             snapshot={k: v for k, v in snap.items() if isinstance(v, (int, float))},
                             weight_bytes=engine.weight_bytes)
        if c.get("cow"):
            out[name]["copied"] = all(torch.equal(pool[5], pool[3]) for layer in engine.pools
                                      for pool in (layer.k, layer.v, layer.k_scale, layer.v_scale)
                                      if pool is not None)
    return out


def ulysses_world(mesh, payload: dict) -> dict:
    """The Ulysses file's one world: op-level cases on the whole world's
    sequence group (forward and grads of this rank's shards), the model's
    local logits with ``cp_impl: ulysses``, and ``zero_cases`` over ``data
    x sequence``."""
    from zero_transformer_tpu_torch import config as tconfig
    from zero_transformer_tpu_torch.models.gpt import Transformer
    from zero_transformer_tpu_torch.ops.ulysses import ulysses_attention

    group = mesh.sequence
    ops = {}
    for name, c in payload["ops"].items():
        q, k, v = (torch.from_numpy(shard(c[x], group.rank, group.size)).requires_grad_() for x in "qkv")
        ids = None if c["ids"] is None else torch.from_numpy(shard(c["ids"], group.rank, group.size))
        o = ulysses_attention(q, k, v, group, causal=True, alibi=c["alibi"], doc_ids=ids)
        grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(shard(c["g"], group.rank, group.size)))
        ops[name] = tuple(x.detach().numpy() for x in (o, *grads))
    models = {}
    for name, c in payload["models"].items():
        model = Transformer(tconfig.model_config(c["zoo"], **c["model"]), device="cpu", seq_group=group)
        model.load_state_dict({n: torch.from_numpy(p) for n, p in c["params"].items()})
        with torch.no_grad():
            models[name] = model(torch.from_numpy(c["tokens"])).numpy()
    return {"ops": ops, "models": models, "zero": zero_cases(mesh, payload["zero"])}


# ------------------------------------------------- tensor-parallel training


def tp_train_cases(mesh, cases: dict) -> dict:
    """Every case's model trained on a ``data x tensor x sequence`` mesh (the
    world's own, one made for the case, or one process): the whole params (and, with
    ``load``, the saved state) loaded through ``ZeroShards``, then the
    case's steps on this data rank's rows of each global batch. Returns the
    losses, grad norms and tokens, the whole state after the steps
    (``state_leaves``, every leaf, as numpy), the rank's replicated params
    (to compare across tensor ranks), its param shapes, persistent bytes
    and the replica audit's verdict."""
    from zero_transformer_tpu_torch import config as tconfig
    from zero_transformer_tpu_torch.models.gpt import Transformer, tp_split_dim
    from zero_transformer_tpu_torch.parallel.mesh import make_mesh, single_process
    from zero_transformer_tpu_torch.parallel.zero import init_train_state, make_replica_audit, make_train_step
    from zero_transformer_tpu_torch.training.optimizer import make_schedule

    out = {}
    for name, c in cases.items():
        shape = (c["data"], c.get("tensor", 1), c["sequence"])
        if shape == (mesh.data.size, mesh.tensor.size, mesh.sequence.size):
            m = mesh
        else:  # every rank runs a one-rank case alone
            m = single_process(mesh.device) if shape == (1, 1, 1) else make_mesh(*shape, "gloo", mesh.device)
        tp = m.tensor if m.tensor.size > 1 else None
        model = Transformer(tconfig.model_config(c.get("zoo", "test"), **c["model"]), device="cpu",
                           tensor_group=tp)
        model.requires_grad_(True).set_sequence_group(m.sequence)
        opt_cfg = tconfig.OptimizerConfig(**c["opt"])
        schedule = make_schedule(opt_cfg)
        state = init_train_state(model, opt_cfg, schedule, m.data, c["stage"])
        if c.get("load"):
            state.shards.load_leaves({k: torch.from_numpy(v) for k, v in c["load"].items()}, c["count"])
            state.step = c["count"]
        else:
            state.shards.load_params({n: torch.from_numpy(p) for n, p in c["params"].items()})
        step = make_train_step(c["stage"], schedule, c.get("accum_dtype", "float32"), m.sequence,
                               seed=c.get("seed", 0))
        rows = c["batches"][0].shape[1] // m.data.size
        lo = m.data.rank * rows
        losses, norms, tokens = [], [], []
        for batch in c["batches"]:
            metrics = step(state, torch.from_numpy(batch[:, lo:lo + rows]))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            tokens.append(metrics["tokens"])
        leaves = state.shards.state_leaves()
        audit = make_replica_audit(state.shards)
        with state.shards.gathered():
            replicated = {n: p.detach().numpy().copy() for n, p in model.named_parameters()
                          if tp is None or tp_split_dim(n) is None}
            shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        out[name] = dict(losses=losses, norms=norms, tokens=tokens, count=int(state.optimizer.count),
                         state={k: v.numpy().copy() for k, v in leaves.items()},
                         params={k.removeprefix("params/"): v.numpy().copy() for k, v in leaves.items()
                                 if k.startswith("params/")},
                         replicated=replicated, shapes=shapes, persistent_bytes=state.shards.persistent_bytes(),
                         diverged=None if audit is None else audit(), tensor_rank=m.tensor.rank,
                         data_rank=m.data.rank)
    return out


def tp_loss_cases(group, c: dict) -> dict:
    """The vocab-parallel losses on this tensor rank's columns of ``c``'s
    whole logits and head: the mean loss (ignore_index -1, ``z_loss``) and
    its grad on the local logits; the chunked next-token loss and its
    grads on the hidden states (this rank's part) and the local head."""
    from zero_transformer_tpu_torch.ops.losses import chunked_next_token_loss, cross_entropy_loss

    width = c["logits"].shape[-1] // group.size
    cols = slice(group.rank * width, (group.rank + 1) * width)
    lo = group.rank * width
    logits = torch.from_numpy(c["logits"][..., cols].copy()).requires_grad_()
    labels = torch.from_numpy(c["labels"])
    full = cross_entropy_loss(logits, labels, ignore_index=-1, z_loss=c["z_loss"], group=group, vocab_lo=lo)
    (g_full,) = torch.autograd.grad(full, logits)
    h = torch.from_numpy(c["hidden"]).requires_grad_()
    w = torch.from_numpy(c["w"][:, cols].copy()).requires_grad_()
    chunked = chunked_next_token_loss(h, w, labels, c["chunk"], ignore_index=-1, z_loss=c["z_loss"], group=group,
                                      vocab_lo=lo)
    dh, dw = torch.autograd.grad(chunked, (h, w))
    return dict(full=full.item(), full_grad=g_full.numpy(), chunked=chunked.item(), chunked_dh=dh.numpy(),
                chunked_dw=dw.numpy())


def tp_training_world(mesh, payload: dict) -> dict:
    """The tensor-parallel training file's one world: ``tp_train_cases`` and
    ``tp_loss_cases`` on the world's tensor group."""
    return {"train": tp_train_cases(mesh, payload["train"]), "losses": tp_loss_cases(mesh.tensor, payload["losses"])}


def tp_attention_cases(mesh, cases: dict) -> dict:
    """Ring and Ulysses on this rank's shards of a ``tensor x sequence``
    mesh: q, k, v cut to the rank's sequence shard and its tensor rank's
    heads. {case: (out, dq, dk, dv, out with the old slopes)}: the last is
    the forward with no tensor group (the slopes of heads 0 .. H_local - 1,
    the offset before tensor ranks were counted)."""
    from zero_transformer_tpu_torch.ops.ring_attention import ring_attention
    from zero_transformer_tpu_torch.ops.ulysses import ulysses_attention

    seq, tp = mesh.sequence, mesh.tensor
    out = {}
    for name, c in cases.items():
        fn = ulysses_attention if c["engine"] == "ulysses" else ring_attention

        def local(x):  # this rank's time shard and head slice
            return torch.from_numpy(shard(shard(x, seq.rank, seq.size, 1), tp.rank, tp.size, 2).copy())

        q, k, v = (local(c[x]).requires_grad_() for x in "qkv")
        ids = None if c["ids"] is None else torch.from_numpy(shard(c["ids"], seq.rank, seq.size))
        o = fn(q, k, v, seq, causal=True, alibi=c["alibi"], doc_ids=ids, tensor_group=tp)
        grads = torch.autograd.grad(o, (q, k, v), local(c["g"]))
        with torch.no_grad():
            old = fn(q, k, v, seq, causal=True, alibi=c["alibi"], doc_ids=ids)
        out[name] = tuple(x.detach().numpy() for x in (o, *grads, old))
    return out


def tp_sequence_world(mesh, payload: dict) -> dict:
    """The tensor x sequence file's one world: ``tp_attention_cases`` and
    ``tp_train_cases``."""
    return {"attention": tp_attention_cases(mesh, payload["attention"]),
            "train": tp_train_cases(mesh, payload["train"])}


def tp_checkpoint_world(mesh, payload: dict) -> dict:
    """The tensor checkpoint file's one world: ``tp_train_cases`` (the
    world's mesh: data 2 x tensor 2), then the trainer at data 2 x tensor 2
    for 4 steps (saving at steps 2 and 4), and the trainer at data 4 x
    tensor 1 resuming its step 2 for steps 3-4. Returns the cases, and for
    each trainer its logged losses, its whole state after its steps and
    its whole state before them (for the resume: right after the
    restore)."""
    import shutil

    from zero_transformer_tpu_torch import config as tconfig
    from zero_transformer_tpu_torch.parallel.mesh import make_mesh
    from zero_transformer_tpu_torch.training.trainer import Trainer

    out = {"cases": tp_train_cases(mesh, payload["cases"])}

    def run(m, overrides, steps, chaos=None):
        cfg = tconfig.apply_dotted_overrides(tconfig.load_config(payload["config"]), overrides)
        trainer = Trainer(cfg, device="cpu", mesh=m, chaos=chaos)
        try:
            restored = {k: v.numpy().copy() for k, v in trainer.state.shards.state_leaves().items()}
            trainer.train(max_steps=steps)
            leaves = {k: v.numpy().copy() for k, v in trainer.state.shards.state_leaves().items()}
        finally:
            trainer.close()
        res = {"state": leaves, "restored": restored, "step": trainer.state.step,
               "report": dict(trainer.resilience_report)}
        if m.rank == 0:
            lines = (Path(cfg.checkpoint.directory) / "metrics.jsonl").read_text().splitlines()
            res["losses"] = {r["step"]: r["loss"] for r in map(json.loads, lines) if "loss" in r}
        return res

    base = payload["overrides"]
    tp_dir, resume_dir, rollback_dir = payload["dirs"]
    out["tensor"] = run(mesh, {**base, "mesh.data": 2, "mesh.tensor": 2, "checkpoint.directory": tp_dir}, 4)
    if mesh.rank == 0:
        shutil.copytree(Path(tp_dir) / "2", Path(resume_dir) / "2")
    mesh.barrier()
    data4 = make_mesh(4, 1, 1, "gloo", mesh.device)
    out["resumed"] = run(data4, {**base, "mesh.data": 4, "mesh.tensor": 1, "checkpoint.directory": resume_dir,
                                 "checkpoint.resume": True}, 2)
    from zero_transformer_tpu_torch.resilience.chaos import ChaosMonkey, Fault

    out["rollback"] = run(mesh, {**base, "mesh.data": 2, "mesh.tensor": 2, "checkpoint.directory": rollback_dir,
                                 **payload["rollback"]}, payload["rollback_steps"],
                          chaos=ChaosMonkey([Fault("nan_step", *payload["nan_steps"])]))
    return out
