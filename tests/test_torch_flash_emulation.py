"""The yardstick of the bf16 K1 kernel, held on the CPU.

``chip_smoke.py`` holds the tensor-core forward to ``flash_mma_emulation``,
a step-by-step model of the kernel's rounding (its key tiles, p rounded to
bf16, the output rounded once), at bars of one bf16 ulp plus 2^-13. Here
that emulation, with p and the output kept in float32 and float32 inputs,
must equal the port's plain version ``flash_reference`` within 1e-5 at
every key-tile width (the function does not depend on the tile: only its
rounding does), on a case with every input the kernel takes: B 2, T 96
queries against S 160 keys, 4 query heads on 2 kv heads, D 64 and 128,
per-row query and key offsets, a validity mask and separate query and key
document ids. The same unrounded emulation must also equal the JAX
reference, ``ops/pallas/flash.py::_fwd`` in Pallas interpret mode, on the
same inputs within 1e-5. And the bar must tell a kernel whose causal limit
is one key off from the true one: the emulation at offsets one later misses
it.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zero_transformer_tpu.ops.pallas import flash as jflash
from zero_transformer_tpu_torch.ops import flash as tflash

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)  # its main() runs only as a script

ATOL = 1e-5
B, T, S, H, KVH = 2, 96, 160, 4, 2
Q_OFF, KV_OFF = [64, 100], [0, 40]  # every query row's own position lies in its row's key range
SEPARATORS = (30, 90, 131, 170)  # global positions where a document starts


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(D: int, dtype):
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
               for shape in ((B, T, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    seg = torch.ones(B, S, dtype=torch.int32)
    seg[0, 150:] = 0
    seg[1, 100:105] = 0

    def ids(offsets, n):  # document ids of global positions: separators before each
        pos = torch.tensor(offsets)[:, None] + torch.arange(n)
        return sum((pos >= p).int() for p in SEPARATORS).to(torch.int32)

    return q, k, v, seg, ids(Q_OFF, T), ids(KV_OFF, S)


def _emulation(q, k, v, seg, q_ids, k_ids, offsets, **kw):
    return chip_smoke.flash_mma_emulation(q, k, v, torch.tensor(offsets, dtype=torch.int32), seg, q_ids,
                                          kv_offsets=torch.tensor(KV_OFF, dtype=torch.int32), k_docs=k_ids, **kw)


@pytest.mark.parametrize("key_tile", [chip_smoke.K1_KEY_TILE, 32, 128])
@pytest.mark.parametrize("D", [64, 128])
def test_unrounded_emulation_is_the_plain_version(D, key_tile):
    q, k, v, seg, q_ids, k_ids = _case(D, torch.float32)
    out, lse = _emulation(q, k, v, seg, q_ids, k_ids, Q_OFF, round_out=False, round_p=False, key_tile=key_tile)
    ref, ref_lse = tflash.flash_reference(q, k, v, causal=True, alibi=True, q_offset=torch.tensor(Q_OFF),
                                          kv_offset=torch.tensor(KV_OFF), segment_ids=seg, q_ids=q_ids,
                                          k_ids=k_ids, out_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("D", [64, 128])
def test_unrounded_emulation_matches_jax_interpret(D):
    q, k, v, seg, q_ids, k_ids = _case(D, torch.float32)
    out, lse = _emulation(q, k, v, seg, q_ids, k_ids, Q_OFF, round_out=False, round_p=False)
    j_out, j_lse = jflash._fwd(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), True, True, 1.0 / D**0.5, 32, 32, True,
        q_offset=jnp.asarray(Q_OFF, jnp.int32), kv_offset=jnp.asarray(KV_OFF, jnp.int32),
        out_dtype=jnp.float32, q_ids=jnp.asarray(q_ids.numpy()), k_ids=jnp.asarray(k_ids.numpy()),
        segment_ids=jnp.asarray(seg.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("D", [64, 128])
def test_bar_rejects_a_causal_limit_one_key_off(D):
    q, k, v, seg, q_ids, k_ids = _case(D, torch.bfloat16)
    emu, _ = _emulation(q, k, v, seg, q_ids, k_ids, Q_OFF)
    assert chip_smoke.mma_miss(emu, emu)[0] == 0.0
    plus_1, _ = _emulation(q, k, v, seg, q_ids, k_ids, [o + 1 for o in Q_OFF])
    assert chip_smoke.mma_miss(plus_1, emu)[0] > 1.0
