"""PyTorch port vs JAX reference: ring attention over 4 gloo processes.

One world of 4 gloo ranks (data 1 x sequence 4) runs every case of the
file: the port's ``ops/ring_attention.py::ring_attention`` on each rank's
shard of the same seeded numpy q, k, v (B 2, T 128, D 64), forward and
backward against a seeded output grad. The gathered outputs and grads are
held within atol 1e-5 (float32) against:

- JAX ``ring_attention`` on the conftest's CPU mesh with
  ``MeshConfig(data=1, sequence=4)``, both engines: ``impl="flash"`` with
  ``interpret=True`` (Pallas ``flash_partial``/``flash_grads``) and
  ``impl="xla"`` (the einsum ring);
- the port's one-process ``ops.flash.flash_attention`` on the whole row.

Cases: ALiBi on and off, GQA (4 query heads on 2 kv heads), and packed
document ids whose documents cross the shard boundaries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from zero_transformer_tpu.config import MeshConfig
from zero_transformer_tpu.ops.ring_attention import ring_attention as jax_ring
from zero_transformer_tpu.parallel.mesh import make_mesh
from zero_transformer_tpu_torch.ops import flash as tflash
from zero_transformer_tpu_torch.ops.ring_attention import ring_attention

ATOL = 1e-5
B, T, D, WORLD = 2, 128, 64, 4
CASES = {  # name: (H, KVH, alibi, docs)
    "alibi": (4, 4, True, False),
    "no_alibi": (4, 4, False, False),
    "gqa": (4, 2, True, False),
    "docs": (4, 4, True, True),
}
REFERENCES = ("jax_flash_interpret", "jax_xla", "port_one_process")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(name):
    H, KVH, alibi, docs = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 40)
    q, k, v = (rng.standard_normal((B, T, h, D)).astype(np.float32) for h in (H, KVH, KVH))
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)
    ids = None
    if docs:
        sep = np.zeros((B, T), np.int32)
        sep[0, [5, 31, 32, 70, 100]] = 1  # on and next to the shard edge at 32
        sep[1, [47, 64 + 30]] = 1
        ids = (np.cumsum(sep, axis=1) - sep).astype(np.int32)
    return dict(q=q, k=k, v=v, g=g, ids=ids, alibi=alibi)


@pytest.fixture(scope="module")
def ring_results(tmp_path_factory):
    """Every case through the port's ring in one 4-rank gloo world,
    gathered along the sequence."""
    payload = {name: _case(name) for name in CASES}
    ranks = _torch_dist.run_world("ring_cases", payload, tmp_path_factory.mktemp("ring"), world=WORLD)
    return {name: [np.concatenate([r[name][i] for r in ranks], axis=1) for i in range(4)] for name in CASES}


def _jax_reference(c, impl):
    mesh = make_mesh(MeshConfig(data=1, sequence=WORLD), devices=jax.devices()[:WORLD])
    ids = None if c["ids"] is None else jnp.asarray(c["ids"])
    kw = dict(causal=True, alibi=c["alibi"], doc_ids=ids, impl=impl)
    if impl == "flash":
        kw["interpret"] = True

    def f(q, k, v):
        return jax_ring(q, k, v, mesh, **kw)

    qkv = [jnp.asarray(c[x]) for x in "qkv"]
    g = jnp.asarray(c["g"])
    out = jax.jit(f)(*qkv)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * g), argnums=(0, 1, 2)))(*qkv)
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


def _port_one_process(c):
    q, k, v = (torch.from_numpy(c[x]).requires_grad_() for x in "qkv")
    ids = None if c["ids"] is None else torch.from_numpy(c["ids"])
    out = tflash.flash_attention(q, k, v, causal=True, alibi=c["alibi"], doc_ids=ids)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(c["g"]))
    return [out.detach().numpy()] + [x.numpy() for x in grads]


@pytest.mark.parametrize("reference", REFERENCES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches(ring_results, name, reference):
    c = _case(name)
    if reference == "port_one_process":
        want = _port_one_process(c)
    else:
        want = _jax_reference(c, "flash" if reference == "jax_flash_interpret" else "xla")
    for what, got, ref in zip(("out", "dq", "dk", "dv"), ring_results[name], want):
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=f"{name} {what} vs {reference}")


def test_ring_refuses_unequal_shards_and_bad_ids():
    from zero_transformer_tpu_torch.parallel.mesh import SequenceGroup

    group = SequenceGroup(rank=0, size=2, backend="gloo", device=torch.device("cpu"))
    q = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError, match="one length"):
        ring_attention(q, torch.zeros(1, 4, 4, 64), torch.zeros(1, 4, 4, 64), group)
    with pytest.raises(ValueError, match="kv heads"):
        ring_attention(q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64), group)
    with pytest.raises(ValueError, match="doc_ids"):
        ring_attention(q, q, q, group, doc_ids=torch.zeros(1, 16, dtype=torch.int32))
