"""The port's counter hashes and Philox generator.

- ``hash_uniform01``/``hash_randint`` equal the reference's interpret-mode
  hashes (``smol_tpu.ops.pallas_chain._hash_uniform01``/``_hash_randint``)
  bit for bit, over a grid of (seed, step, slot, lane) that includes
  negative seeds and int32 wrap-around in every product;
- ``philox4x32_10`` matches the Random123 known-answer vectors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smol_tpu.ops import pallas_chain
from smol_tpu_torch.ops import rng

SEEDS = [0, 1, 7919, 123456789, 2**30 - 2, 2**31 - 1, -1, -5, -(2**31)]
STEPS = [0, 1, 2047, 65535, 2**31 - 1]
LANES = 256


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_uniform_bit_identical(seed):
    lanes = torch.arange(LANES)
    for step in STEPS:
        for slot in (0, 1, 5):
            ref = np.asarray(
                pallas_chain._hash_uniform01(
                    jnp.int32(seed), jnp.int32(step), slot, (1, LANES)
                )
            )[0]
            mine = rng.hash_uniform01(seed, step, slot, lanes).numpy()
            assert mine.dtype == np.float32
            np.testing.assert_array_equal(mine.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("bound", [1, 2, 3, 7])
def test_hash_randint_bit_identical(bound):
    lanes = torch.arange(LANES)
    for seed in SEEDS:
        for step in STEPS:
            ref = np.asarray(
                pallas_chain._hash_randint(
                    jnp.int32(seed), jnp.int32(step), 0, (1, LANES), jnp.int32(bound)
                )
            )[0]
            mine = rng.hash_randint(seed, step, 0, lanes, bound).numpy()
            np.testing.assert_array_equal(mine, ref)


def test_hash_broadcasts_over_steps_and_walkers():
    """A [steps, lanes] grid equals the per-step rows (the chain's layout)."""
    lanes = torch.arange(16)
    steps = torch.arange(5)[:, None]
    seeds = torch.tensor([3, -3] * 8)
    grid = rng.hash_bits(seeds, steps, 1, lanes)
    for i in range(5):
        row = rng.hash_bits(seeds, i, 1, lanes)
        assert torch.equal(grid[i], row)


@pytest.mark.parametrize(
    "counter,key,expected",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        (
            (0xFFFFFFFF,) * 4,
            (0xFFFFFFFF,) * 2,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD),
        ),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
)
def test_philox_known_answers(counter, key, expected):
    out = rng.philox4x32_10(
        torch.tensor(counter, dtype=torch.int64), torch.tensor(key, dtype=torch.int64)
    )
    assert [int(v) for v in out] == list(expected)


def test_philox_batched_equals_scalar():
    counters = torch.randint(0, 2**32, (6, 4), generator=torch.Generator().manual_seed(0))
    keys = torch.randint(0, 2**32, (6, 2), generator=torch.Generator().manual_seed(1))
    batched = rng.philox4x32_10(counters, keys)
    for i in range(6):
        assert torch.equal(batched[i], rng.philox4x32_10(counters[i], keys[i]))


def test_uniform01_range():
    """Uniforms lie in (0, 1] and take the reference's 2**-24 grid."""
    r = torch.tensor([0, 127, 128, 2**31 - 1])
    u = rng.uniform01_from_bits(r)
    assert u.dtype == torch.float32
    assert u.tolist() == [2.0**-24, 2.0**-24, 2.0**-23, 1.0]
