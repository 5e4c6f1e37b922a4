"""PyTorch port vs JAX reference: training the Llama block, on 4 ranks.

``llama3_test`` widened to d_model 128 (4 heads on 2 kv heads of 32, d_ff
384: Adafactor factors every kernel, the gate, the untied head and the
embedding; float32, dropout 0) trains three optimizer steps on 4 gloo
processes from the JAX init converted by ``params_from_jax``; each data
rank takes its quarter of every global batch [1, 8, 16]. AdamW, Adafactor
and Lion at ZeRO stages 0 and 3 are held against JAX
``parallel/zero.make_train_step`` called directly on a CPU mesh of data 4
at the same stage (stage 3 with the shard-aware clip through
``tx_factory``): loss and grad norm per step and every param after the
steps within 1e-5 (AdamW within 2e-6; Lion allows its rare rounding-decided
sign flips, as ``test_torch_zero_optimizers.py`` explains); the ranks hold
bit-equal params.

The same world runs the ring: ``llama3_test`` (RoPE at the shard's global
positions) and a learned-position model on rows of 32 split over the 4
ranks; the ranks' loss shares and grads summed equal one process's loss and
grads within 1e-5.

One process: Adafactor's factoring follows JAX's shapes at ``llama3_8b``
(the untied head ``[d, V]``, the stacked gate) and for ``wpe``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from test_torch_optimizers import _jax_state_numel
from zero_transformer_tpu import config as jconfig
from zero_transformer_tpu.models import Transformer as JaxTransformer
from zero_transformer_tpu.parallel import init_train_state, make_mesh, make_plan
from zero_transformer_tpu.parallel import make_train_step as jax_make_train_step
from zero_transformer_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from zero_transformer_tpu.training.optimizer import make_schedule as jax_make_schedule
from zero_transformer_tpu_torch import config as tconfig
from zero_transformer_tpu_torch.convert import params_from_jax
from zero_transformer_tpu_torch.models.gpt import Transformer
from zero_transformer_tpu_torch.training import optimizer as topt

WORLD, B, T, STEPS = 4, 8, 16, 3
ZOO = "llama3_test"
MODEL = dict(d_model=128, dropout=0.0, compute_dtype="float32")
OPT = dict(peak_learning_rate=1e-2, warmup_steps=2, total_steps=64)
ATOL = {"adamw": 2e-6, "adafactor": 1e-5, "lion": 1e-5}
CASES = {f"{name}_stage{stage}": (name, stage) for name in ("adamw", "adafactor", "lion") for stage in (0, 3)}
RING = {"rope": ("llama3_test", dict(dropout=0.0, compute_dtype="float32")),
        "learned": ("test", dict(dropout=0.0, compute_dtype="float32", position="learned"))}
RING_T = 32
# see test_torch_zero_optimizers.py: at most this share of Lion's elements
# may take the other sign of an update decided by rounding
SIGN_FLIP_SHARE = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batches(name):
    rng = np.random.default_rng(sorted(CASES).index(name) + 60)
    return rng.integers(0, 256, (STEPS, 1, B, T)).astype(np.int32)


def _jax_run(name):
    opt_name, stage = CASES[name]
    jopt = jconfig.OptimizerConfig(optimizer=opt_name, **OPT)
    mesh = make_mesh(jconfig.MeshConfig(data=WORLD, zero_stage=stage), devices=jax.devices()[:WORLD])
    jmodel = JaxTransformer(jconfig.model_config(ZOO, **MODEL))
    tx = jax_make_optimizer(jopt)
    plan = make_plan(jmodel, tx, mesh, (B, T), stage)
    jstate = init_train_state(jmodel, tx, jax.random.PRNGKey(7), mesh, (B, T), plan)
    init = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    factory = None
    if stage >= 2:
        def factory(norm_fn, zc=None):
            return jax_make_optimizer(jopt, None, norm_fn, zero_collectives=zc)
    step = jax_make_train_step(jmodel, tx, mesh, plan, stage, jax_make_schedule(jopt), tx_factory=factory)
    losses, norms = [], []
    for batch in _batches(name):
        jstate, m = step(jstate, jnp.asarray(batch), jax.random.PRNGKey(42))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    after = {n: p.numpy() for n, p in params_from_jax(jax.tree.map(np.asarray, jstate.params)).items()}
    return {n: p.numpy() for n, p in init.items()}, losses, norms, after


def _ring_inputs(name):
    zoo, over = RING[name]
    model = Transformer(tconfig.model_config(zoo, **over), device="cpu")
    model.init_weights(torch.Generator().manual_seed(11))
    tokens = np.random.default_rng(12).integers(0, 256, (2, RING_T)).astype(np.int64)
    return model, tokens


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_runs = {name: _jax_run(name) for name in CASES}
    zero = {name: dict(zoo=ZOO, model=MODEL, params=jax_runs[name][0],
                       opt={**OPT, "optimizer": CASES[name][0]}, batches=list(_batches(name)), data=WORLD,
                       sequence=1, stage=CASES[name][1], accum_dtype="float32")
            for name in CASES}
    ring = {}
    for name, (zoo, over) in RING.items():
        model, tokens = _ring_inputs(name)
        ring[name] = dict(zoo=zoo, model=over, tokens=tokens,
                          params={n: p.numpy() for n, p in model.state_dict().items()})
    ranks = _torch_dist.run_world("llama_world", {"zero": zero, "ring": ring},
                                  tmp_path_factory.mktemp("llama"), world=WORLD, sequence=1)
    return jax_runs, ranks


@pytest.mark.parametrize("name", sorted(CASES))
def test_zero_step_matches_jax_make_train_step(runs, name):
    jax_runs, ranks = runs
    _, losses, norms, after = jax_runs[name]
    opt_name = CASES[name][0]
    got = ranks[0]["zero"][name]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["norms"], norms, rtol=1e-5, atol=1e-5)
    assert set(got["params"]) == set(after)
    assert {"lm_head.weight", "blocks.0.mlp.gate.weight"} <= set(after)
    if opt_name != "lion":
        for n, p in got["params"].items():
            np.testing.assert_allclose(p, after[n], atol=ATOL[opt_name], rtol=0, err_msg=f"{name} {n}")
    else:
        schedule = topt.make_schedule(tconfig.OptimizerConfig(**OPT))
        flips = 2.1 * sum(schedule(i) for i in range(STEPS)) + ATOL["lion"]
        diff = np.concatenate([np.abs(p - after[n]).ravel() for n, p in got["params"].items()])
        assert (diff > ATOL["lion"]).mean() <= SIGN_FLIP_SHARE and diff.max() <= flips
    for r in ranks[1:]:
        assert r["zero"][name]["losses"] == got["losses"]
        assert all(np.array_equal(r["zero"][name]["params"][n], p) for n, p in got["params"].items())


@pytest.mark.parametrize("name", sorted(RING))
def test_ring_matches_one_process(runs, name):
    _, ranks = runs
    model, tokens = _ring_inputs(name)
    model.requires_grad_(True)
    t = torch.from_numpy(tokens)
    _, loss = model(t, labels=t, train=True)
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    shares = [r["ring"][name] for r in ranks]
    np.testing.assert_allclose(sum(s[0] for s in shares), float(loss.detach()), atol=1e-5, rtol=0)
    for (n, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(sum(s[1][n] for s in shares), g.numpy(), atol=1e-5, rtol=0, err_msg=n)


def test_adafactor_factoring_follows_jax_shapes():
    tx = jax_make_optimizer(jconfig.OptimizerConfig(optimizer="adafactor"))
    for zoo, over in (("llama3_8b", {}), ("test", dict(d_model=128, position="learned", max_seq_len=256))):
        model = Transformer(tconfig.model_config(zoo, **over), device="meta")
        jmodel = JaxTransformer(jconfig.model_config(zoo, **over))
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        assert topt.factored_state_numel(shapes, scan_layers=True) == _jax_state_numel(jmodel, tx)
    cfg = tconfig.model_config("llama3_8b")
    shapes = {n: tuple(p.shape) for n, p in Transformer(cfg, device="meta").named_parameters()}
    L = cfg.n_layers
    # JAX's head [4096, 128256]: v_row over the vocab (the port weight's dim 0), v_col over d
    assert topt.factoring("lm_head.weight", shapes["lm_head.weight"], L, True) == ("lm_head.weight", (0, 1))
    # the gate [L, 4096, 14336] stacked: factored per layer over d and d_ff
    assert topt.factoring("blocks.3.mlp.gate.weight", shapes["blocks.3.mlp.gate.weight"], L, True) == \
        ("blocks.*.mlp.gate.weight", (0, 1))
    wide = tconfig.model_config("test", d_model=128, position="learned", max_seq_len=256)
    wpe = tuple(Transformer(wide, device="meta").wpe.embedding.shape)
    assert topt.factoring("wpe.embedding", wpe, 2, True) == ("wpe.embedding", (0, 1))
