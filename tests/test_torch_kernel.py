"""The CUDA flip-chain kernel against its plain torch twin, on the card.

Marked ``cuda``: each test skips without a CUDA device (and ``nvcc``).
This file imports neither ``jax`` nor ``smol_tpu``, so it also runs where
they are not installed; there, run it without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernel.py

The kernel must equal the twin on every walker in both RNG modes
(occupancies and accept counts exactly, enthalpies to 1e-9 absolute),
including a partial CUDA block, sequence blocks smaller than a CUDA
block, the main path's launch shape (8192 walkers in blocks of 1024) and
the general (runtime slot count) kernel; a refused operand raises before
any launch.
"""

import dataclasses
from pathlib import Path

import pytest
import torch

from smol_tpu_torch.constants import kB
from smol_tpu_torch.moca.ensemble import Ensemble, random_occupancies
from smol_tpu_torch.ops import chain
from smol_tpu_torch.system import load_system

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _operands(card, cell, W, n_steps, block_size):
    ens = Ensemble.from_system(load_system(DATA / f"torch_spinel_{cell}.npz"), card)
    tables = chain.build_chain_tables(
        ens.processor, ens.sublattices, mu_table=ens.chemical_potential_table
    )
    occu = torch.as_tensor(random_occupancies(ens, W, seed=3), device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    return dict(
        occ=occu[:, tables.rank_sites].T.to(torch.int8).contiguous(),
        enthalpy=torch.zeros(W, dtype=torch.float64, device=card),
        naccept=torch.zeros(W, dtype=torch.int32, device=card),
        beta32=torch.full((W,), 1 / (kB * 1000.0), dtype=torch.float32, device=card),
        seq=chain.rank_sequence(tables, gen, (-(-W // block_size), n_steps)),
        seed=torch.tensor([12345], dtype=torch.int64, device=card),
        tables=tables, n_steps=n_steps, block_size=block_size,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
@pytest.mark.parametrize(
    "cell,W,block_size",
    [("2x2x2", 256, 64), ("3x3x3", 1000, 1024), ("2x2x2", 200, 8),
     ("3x3x3", 8192, 1024)],  # the last: the main path's launch shape
)
def test_kernel_matches_twin(card, rng, cell, W, block_size):
    ops = _operands(card, cell, W, 400, block_size)
    outs = []
    for fn in (chain.flip_chain, chain.flip_chain_reference):
        run = {k: (v.clone() if k in ("occ", "enthalpy", "naccept") else v)
               for k, v in ops.items()}
        before = chain.flip_chain.launches
        fn(**run, rng=rng)
        torch.cuda.synchronize()
        launched = chain.flip_chain.launches - before
        assert launched == (1 if fn is chain.flip_chain else 0)
        outs.append(run)
    kernel, twin = outs
    assert torch.equal(kernel["occ"], twin["occ"])
    assert torch.equal(kernel["naccept"], twin["naccept"])
    assert float((kernel["enthalpy"] - twin["enthalpy"]).abs().max()) <= 1e-9
    assert 0 < float(kernel["naccept"].double().mean()) < 400


@pytest.mark.cuda
@pytest.mark.parametrize("rng", ["hash", "philox"])
def test_general_slot_count_matches_twin(card, rng):
    """A fourth, empty slot (nbr -1, stride 0) takes the runtime-K kernel."""
    ops = _operands(card, "2x2x2", 256, 400, 64)
    t = ops["tables"]
    padded = dataclasses.replace(
        t,
        nbr=torch.nn.functional.pad(t.nbr, (0, 1), value=-1),
        stride=torch.nn.functional.pad(t.stride, (0, 1), value=0),
    )
    outs = []
    for fn, tables in ((chain.flip_chain, padded), (chain.flip_chain_reference, t)):
        run = {k: (v.clone() if k in ("occ", "enthalpy", "naccept") else v)
               for k, v in ops.items()}
        fn(**{**run, "tables": tables}, rng=rng)
        outs.append(run)
    torch.cuda.synchronize()
    kernel, twin = outs
    assert torch.equal(kernel["occ"], twin["occ"])
    assert torch.equal(kernel["naccept"], twin["naccept"])
    assert float((kernel["enthalpy"] - twin["enthalpy"]).abs().max()) <= 1e-9


@pytest.mark.cuda
def test_refused_operand_raises_before_launch(card):
    ops = _operands(card, "2x2x2", 64, 10, 64)
    before = chain.flip_chain.launches
    with pytest.raises(ValueError):
        chain.flip_chain(**{**ops, "occ": ops["occ"].to(torch.int32)})
    with pytest.raises(ValueError):
        chain.flip_chain(**{**ops, "seed": ops["seed"].cpu()})
    assert chain.flip_chain.launches == before
