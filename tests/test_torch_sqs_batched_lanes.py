"""A batched SQS search whose lanes differ from its shapes' own, on the
CPU, through the port's twins: each shape's draws, codes and accept counts
stay equal to the shape-by-shape search's and its scores agree to 1e-12.

It takes as long as the other batched tests together
(``tests/test_torch_sqs_batched.py``, whose helpers it shares), so it sits
in a file of its own that ``--dist loadfile`` can run on another worker.
"""

import numpy as np
import torch

from smol_tpu_torch.capp import StochasticSQSGenerator
from smol_tpu_torch.ops import sqs

from test_torch_sqs_batched import _batch_processors, _generate_shape_by_shape


def test_batched_generate_lanes_follow_the_launch():
    """Where a batch's lanes differ from a shape's own (4 shapes of 1024
    walkers: 8 lanes together, 16 alone), what the batch does not change
    and what it may: each shape's draws (starts, pairs, random numbers) are
    its own, so its start scores are equal bit for bit and, with no
    acceptance here within the rounding of its threshold, so are its codes
    and accept counts at every stage; the order of df's sums follows the
    launch, so its scores agree only to rounding (1e-12), and among
    structures of one score a walker may keep another as its best."""
    procs = _batch_processors()
    W, temperatures = 1024, [2.0, 0.5]
    assert sqs.launch_lanes(len(procs) * W) == 8 and sqs.launch_lanes(W) == 16
    generator = StochasticSQSGenerator.from_processors(procs, device="cpu")
    generator.generate(mcmc_steps=30, temperatures=temperatures, nwalkers=W, seed=4)
    best, starts, records = _generate_shape_by_shape(procs, 30, temperatures, W, 4)
    for mine, theirs in zip(generator.start_scores, starts):
        assert torch.equal(mine, theirs)
    assert len(generator.stage_records) == len(records)
    for mine, theirs in zip(generator.stage_records, records):
        assert mine["shape"] == theirs["shape"] and mine["temperature"] == theirs["temperature"]
        assert torch.equal(mine["occupancy"], theirs["occupancy"])
        assert torch.equal(mine["naccept"], theirs["naccept"])
        torch.testing.assert_close(mine["enthalpy"], theirs["enthalpy"], rtol=0, atol=1e-12)
    for (s1, _, sc1, _), (s2, _, sc2, _) in zip(generator._best, best):
        assert s1 == s2
        np.testing.assert_allclose(sc1, sc2, rtol=0, atol=1e-12)
