"""KV-cached autoregressive generation, and the paged decode model's pools.

Counterpart of ``zero_transformer_tpu/inference/generate.py``: ``decode_model``
(:30-50), ``init_cache`` (:94), ``prefill`` (:181), ``generate`` (:193) with
its decode loop (``_start_decode`` :241, ``_decode_loop`` :275),
``stream_tokens`` (:351, the fused step of ``_stream_step`` :334) and
``generate_tokens`` (:402). In JAX the decode variant is a separate flax
module whose cache is a pytree returned by every apply; in the port the one
``Transformer`` has a ``forward_paged`` method and the cache is a list of
per-layer ``KVPools`` that the forward updates IN PLACE (where JAX donates
its cache buffers).

The slab cache of ``generate`` (JAX's per-layer ``cached_key`` /
``cached_value`` ``[B, cache_len, KVH, D]``, int8 with float32 scales under
``kv_cache_dtype: int8``, and one scalar ``cache_index``) is a
``SlabCache``: the same slab, rounded up to whole pages of ``SLAB_PAGE``
positions, seen without a copy as a page pool ``[B * n_blocks, page, KVH,
D]`` through an identity block table (row b owns pages ``b * n_blocks`` to
``(b + 1) * n_blocks - 1``), its cursor a host int broadcast to ``[B]``
offsets. So the serving engine's ``forward_paged`` runs it unchanged: a
window of at most ``MAX_DECODE_T`` tokens (a decode step, a short verify
window) reads the slab through the paged decode kernel, a longer one (the
prompt, a long verify window) through the flash kernel over the gathered
rows and their validity mask. The overflow poison keeps the requested
``cache_len``. JAX's slab path leaves single-token decode to XLA; on CUDA
the port's wrappers take a kernel or raise, so here the kernels take it.

The loop runs eagerly in ``stream_tokens``, which hands each step's tokens
to its caller; ``generate`` collects them and pads after EOS. It reads the
device only to stop early once every row has emitted EOS (one read per
decode step, none without ``eos_token_id``; a host prompt goes to the card
through pinned memory, which does not wait either).
Categorical draws come from one ``torch.Generator`` (a [B, V] draw per
sampled step) or from injected ``uniforms`` (``sampling.sample_token``).

Tensor-parallel serving (JAX ``serve_mesh`` :52, ``shard_for_inference``
:66, ``init_cache(..., mesh=)`` :94): ``serve_mesh(N)`` is the
``TensorGroup`` of N ranks, one process each (the serve CLI starts them);
``shard_for_inference`` cuts a whole converted state dict into a rank's
shard (``models/gpt.py::tp_split_dim``), and ``scatter_for_inference``
loads each rank's shard from rank 0's whole tree, one tensor at a time; a
model built over the group (``model_getter(..., tensor_group=)``) holds
``KVH / N`` kv heads a rank, so ``init_cache`` and ``allocate_pools`` allocate those. ``generate``,
``stream_tokens`` and ``generate_tokens`` run unchanged on every rank of the
group (each forward's collectives pair up across the ranks); the logits are
whole on every rank and each step's tokens are rank 0's, broadcast, so the
ranks stop together.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import torch

from zero_transformer_tpu_torch.config import ModelConfig, resolve_dtype
from zero_transformer_tpu_torch.convert import tensor_shard
from zero_transformer_tpu_torch.inference.sampling import SamplingConfig, sample_token
from zero_transformer_tpu_torch.models.gpt import KVPools, Pools, Transformer, check_tensor_split
from zero_transformer_tpu_torch.parallel.mesh import TensorGroup

SLAB_PAGE = 16  # positions per page of the slab's page view (the serving default)


def decode_model(model: Transformer, cache_len: int, kv_pages: Tuple[int, int]) -> Transformer:
    """The paged decode variant: ``model`` itself, whose ``forward_paged``
    reads and writes ``kv_pages = (n_pages, page_size)`` pools. Checks the
    paged geometry as JAX ``decode_model`` does and returns the model."""
    n_pages, page = kv_pages
    if page < 1 or n_pages < 2:
        raise ValueError(
            f"kv_pages needs page_size >= 1 and n_pages >= 2 (one trash page + one real page), got {kv_pages}"
        )
    if cache_len % page:
        raise ValueError(f"page_size ({page}) must divide cache_len ({cache_len})")
    return model


def allocate_pools(cfg: ModelConfig, n_pages: int, page_size: int, device,
                   dtype: Optional[torch.dtype] = None, kv_heads: Optional[int] = None) -> Pools:
    """One zeroed ``[n_pages, page, KVH, D]`` K/V pool pair per layer: in
    the compute dtype (``kv_cache_dtype: auto``), or int8 with zeroed
    float32 scale pools ``[n_pages, page, KVH, 1]`` (``int8``, JAX
    ``gpt.py:233-237``). ``kv_heads`` (default the model's) is a tensor
    rank's ``KVH / N``. The serving engine keeps page 0 as its trash page."""
    shape = (n_pages, page_size, kv_heads or cfg.kv_heads, cfg.head_width)
    if cfg.kv_cache_dtype == "int8":
        sc_shape = shape[:-1] + (1,)
        return [
            KVPools(*(torch.zeros(shape, dtype=torch.int8, device=device) for _ in range(2)),
                    *(torch.zeros(sc_shape, dtype=torch.float32, device=device) for _ in range(2)))
            for _ in range(cfg.n_layers)
        ]
    dtype = dtype or resolve_dtype(cfg.compute_dtype)
    return [
        KVPools(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(cfg.n_layers)
    ]


@dataclasses.dataclass
class SlabCache:
    """The ``[B, cache_len]`` KV cache of ``generate``: per layer a slab
    seen as pages (``pools``), the identity ``table`` [B, n_blocks] int32
    and the cursor ``index`` (JAX's scalar ``cache_index``) on the host."""

    pools: Pools
    table: torch.Tensor
    cache_len: int
    index: int = 0

    @property
    def batch(self) -> int:
        return self.table.shape[0]

    def slab(self, layer: int, name: str = "k") -> torch.Tensor:
        """JAX's ``cached_key`` (``"k"``), ``cached_value`` (``"v"``),
        ``key_scale`` (``"k_scale"``) or ``value_scale`` (``"v_scale"``) of
        ``layer``: a ``[B, cache_len, KVH, D or 1]`` view."""
        t = getattr(self.pools[layer], name)
        return t.view(self.batch, -1, *t.shape[2:])[:, :self.cache_len]

    def forward(self, model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens`` [B, T] at positions ``index`` ..: writes their K/V,
        advances the cursor by T and returns the final hidden states."""
        offsets = torch.full((self.batch,), self.index, dtype=torch.int32, device=self.table.device)
        h = model.forward_paged(tokens, self.pools, self.table, offsets, self.cache_len)
        self.index += tokens.shape[1]
        return h


def model_device(model: Transformer) -> torch.device:
    return next(model.parameters()).device


def init_cache(model: Transformer, batch: int, cache_len: Optional[int] = None) -> SlabCache:
    """A zeroed slab cache for ``batch`` rows of ``cache_len`` positions
    (default ``max_seq_len``, as JAX's ``model.cache_len or
    cfg.max_seq_len``) on the model's device."""
    cfg = model.cfg
    cache_len = cache_len or cfg.max_seq_len
    device = model_device(model)
    n_blocks = -(-cache_len // SLAB_PAGE)
    pools = allocate_pools(cfg, batch * n_blocks, SLAB_PAGE, device, kv_heads=model.blocks[0].attn.kv_heads)
    table = torch.arange(batch * n_blocks, dtype=torch.int32, device=device).view(batch, n_blocks)
    return SlabCache(pools, table, cache_len)


@torch.no_grad()
def prefill(model: Transformer, prompt: torch.Tensor, cache: SlabCache) -> torch.Tensor:
    """Run the prompt [B, T] through the model at the cache's cursor,
    filling the cache. Returns the last position's logits [B, V] in float32."""
    h = cache.forward(model, prompt)
    return model.logits(h[:, -1]).float()


def to_device(values, device) -> torch.Tensor:
    """Token ids (a list, a host or device tensor) as an int64 tensor on
    ``device``. A host copy to the card is staged through pinned memory and
    does not wait for it (a copy from pageable memory would)."""
    t = torch.as_tensor(values, dtype=torch.long)
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _prompt(model: Transformer, prompt) -> torch.Tensor:
    prompt = to_device(prompt, model_device(model))
    return prompt[None] if prompt.ndim == 1 else prompt


def check_positions(cfg: ModelConfig, T: int, max_new_tokens: int) -> None:
    """Learned positions stop at ``max_seq_len``: refuse a run past them (the
    table would be read clamped)."""
    if cfg.position == "learned" and T + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({T}) + max_new_tokens ({max_new_tokens}) exceeds max_seq_len ({cfg.max_seq_len}) "
            "and learned positions cannot extrapolate (use position='alibi' or 'rope')"
        )


def _start_decode(model: Transformer, prompt: torch.Tensor, max_new_tokens: int,
                  cache_len: Optional[int]):
    """The guards and the prefill shared by ``generate`` and
    ``stream_tokens``: returns (last logits, cache, penalty mask)."""
    cfg = model.cfg
    cache_len = cache_len or cfg.max_seq_len
    B, T = prompt.shape
    # the final sampled token is never fed back, so the cache holds T + max_new - 1
    if T + max_new_tokens - 1 > cache_len:
        raise ValueError(f"prompt ({T}) + max_new_tokens ({max_new_tokens}) exceeds cache_len ({cache_len})")
    check_positions(cfg, T, max_new_tokens)
    cache = init_cache(model, B, cache_len)
    last_logits = prefill(model, prompt, cache)
    # presence mask of GENERATED tokens for the repetition penalty
    gen_mask = torch.zeros(B, last_logits.shape[-1], dtype=torch.bool, device=last_logits.device)
    return last_logits, cache, gen_mask


def _step_uniforms(uniforms: Optional[torch.Tensor], step: int) -> Optional[torch.Tensor]:
    return None if uniforms is None else uniforms[step]


@torch.no_grad()
def generate(
    model: Transformer,
    prompt,
    max_new_tokens: int,
    generator: Optional[torch.Generator] = None,
    sampling: SamplingConfig = SamplingConfig(),
    eos_token_id: Optional[int] = None,
    pad_token_id: int = 0,
    cache_len: Optional[int] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of a [B, T] prompt.

    Returns [B, max_new_tokens] int64 on the model's device. Rows that hit
    ``eos_token_id`` are padded with ``pad_token_id`` afterwards; the loop
    stops once every row is done. ``generator`` (default: seed 0 on the
    model's device) draws the categorical noise, or ``uniforms``
    [max_new_tokens, B, V] gives each step's. ``cache_len`` defaults to
    ``max_seq_len``. The tokens are ``stream_tokens``'s, padded after EOS
    (a done row's later tokens feed only its own penalty mask)."""
    prompt = _prompt(model, prompt)
    out = torch.full((prompt.shape[0], max_new_tokens), pad_token_id, dtype=torch.long, device=prompt.device)
    done = torch.zeros(prompt.shape[0], dtype=torch.bool, device=prompt.device)
    steps = stream_tokens(model, prompt, max_new_tokens, generator, sampling, eos_token_id, cache_len, uniforms)
    for step, token in enumerate(steps):
        out[:, step] = torch.where(done, pad_token_id, token)
        if eos_token_id is not None:
            done |= token == eos_token_id
    return out


@torch.no_grad()
def stream_tokens(
    model: Transformer,
    prompt,
    max_new_tokens: int,
    generator: Optional[torch.Generator] = None,
    sampling: SamplingConfig = SamplingConfig(),
    eos_token_id: Optional[int] = None,
    cache_len: Optional[int] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Iterator[torch.Tensor]:
    """Yield tokens one step at a time (a [B] int64 tensor per yield): the
    first sampled from the prefill's logits, each later one from the
    forward of the token before it. The final token's forward is skipped
    and the draws come in ``generate``'s order, so the tokens are
    ``generate``'s before its padding. With ``eos_token_id`` the stream
    stops when every row has emitted it (rows that are done keep streaming
    until then), reading the device once a step but the last."""
    prompt = _prompt(model, prompt)
    logits, cache, gen_mask = _start_decode(model, prompt, max_new_tokens, cache_len)
    B = prompt.shape[0]
    dev = logits.device
    generator = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    token = _agree(model, sample_token(logits, sampling, gen_mask, generator, _step_uniforms(uniforms, 0)))
    # a scalar fill: an index_put of a Python True would copy it from the host and wait
    gen_mask.scatter_(1, token[:, None], True)
    for step in range(max_new_tokens):
        yield token
        # the last emitted token is never fed back
        if step + 1 == max_new_tokens:
            return
        if eos_token_id is not None:
            done |= token == eos_token_id
            if bool(done.all()):
                return
        logits = model.logits(cache.forward(model, token[:, None])[:, 0]).float()
        token = _agree(model, sample_token(logits, sampling, gen_mask, generator, _step_uniforms(uniforms, step + 1)))
        gen_mask.scatter_(1, token[:, None], True)


def _agree(model: Transformer, token: torch.Tensor) -> torch.Tensor:
    """Under a tensor group, rank 0's tokens on every rank (the ranks then
    feed and stop on the same tokens); else ``token``."""
    if getattr(model, "tp", None) is not None:
        model.tp.broadcast_([token])
    return token


def generate_tokens(
    model: Transformer,
    prompt,
    max_new_tokens: int,
    generator: Optional[torch.Generator] = None,
    cache_len: Optional[int] = None,
    **kwargs,
) -> torch.Tensor:
    """Convenience wrapper: a 1-D or [B, T] prompt, a cache of
    ``max(max_seq_len, prompt + new)`` positions unless ``cache_len`` is
    given, then ``generate``."""
    prompt = _prompt(model, prompt)
    cache_len = cache_len or max(model.cfg.max_seq_len, prompt.shape[1] + max_new_tokens)
    return generate(model, prompt, max_new_tokens, generator, cache_len=cache_len, **kwargs)


def serve_mesh(tensor: int, device="cuda", rank: Optional[int] = None, init_method: Optional[str] = None,
               backend: Optional[str] = None, timeout_s: Optional[float] = None) -> TensorGroup:
    """The pure tensor-parallel serving mesh of ``tensor`` ranks (JAX
    ``serve_mesh``): this process's ``TensorGroup``. Inside an initialised
    world of ``tensor`` ranks it is that world; else it joins one at
    ``init_method`` as ``rank`` (default: ``torch.distributed.run``'s
    ``RANK`` and ``env://``). NCCL with a card per rank when ``tensor``
    cards are visible, else gloo (``parallel.mesh.init_tensor_group``).
    ``timeout_s``: the collective timeout (default ``TENSOR_TIMEOUT_S``)."""
    import os

    import torch.distributed as dist

    from zero_transformer_tpu_torch.parallel.mesh import TENSOR_TIMEOUT_S, init_tensor_group, tensor_group_of_world

    timeout_s = TENSOR_TIMEOUT_S if timeout_s is None else timeout_s

    if dist.is_initialized():
        if dist.get_world_size() != tensor:
            raise ValueError(f"serve_mesh({tensor}) inside a world of {dist.get_world_size()} ranks")
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return tensor_group_of_world(dist.get_backend(), dev, timeout_s)
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    return init_tensor_group(tensor, rank, init_method or "env://", device, backend, timeout_s)


def shard_for_inference(model: Transformer, params, group: Optional[TensorGroup]) -> dict:
    """This rank's shard of a whole state dict (the port's names, from
    ``convert.params_from_jax`` or ``model.state_dict()`` of a one-rank
    model): every tensor ``tp_split_dim`` names cut into ``group.size``
    slices along that dim and the rank's kept, the others whole. Raises
    when the group does not divide the heads (before any weight moves)."""
    n = 1 if group is None else group.size
    check_tensor_split(model.cfg, n)
    return tensor_shard(params, 0 if group is None else group.rank, n)


def scatter_for_inference(model: Transformer, params, group: TensorGroup) -> None:
    """Load this rank's shard of rank 0's whole state dict into ``model``.
    Only rank 0 holds the whole tree (``params``; None on the others): it
    sends the names, shapes and dtypes, then each tensor alone over the
    group's device, and every rank copies its slices into its weights. No
    rank holds more than one whole tensor beyond rank 0's tree. Raises on
    every rank, before any weight moves, when the group does not divide the
    heads or the names are not the model's."""
    check_tensor_split(model.cfg, group.size)
    specs = group.broadcast_object(
        [(name, tuple(t.shape), t.dtype) for name, t in params.items()] if group.rank == 0 else None)
    names, want = {name for name, _, _ in specs}, set(model.state_dict())
    if names != want:
        raise RuntimeError(f"the weights do not fit the model: missing {sorted(want - names)}, "
                           f"unexpected {sorted(names - want)}")
    with torch.no_grad():
        for name, shape, dtype in specs:
            whole = (params[name].to(group.device) if group.rank == 0
                     else torch.empty(shape, dtype=dtype, device=group.device))
            group.broadcast_([whole])
            model.load_state_dict(shard_for_inference(model, {name: whole}, group), strict=False)
            del whole
