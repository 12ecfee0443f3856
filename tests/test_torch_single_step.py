"""The port's host single-walker API against smol_tpu's, draw for draw.

The reference's kernels have a host face beside their batched device path:
``single_step`` on one numpy occupancy, drawing from the kernel's
``np.random.default_rng(seed)``, which its usher and bias share.  Here, on
the CPU, with the same seeds:

- ``flip_weights_mask`` and ``choose_section_from_partition`` equal the
  reference's;
- ``propose_step`` of ``Flip``, ``Swap``, ``MultiStep`` and ``Composite``
  (on the bench spinel 2x2x2) and of ``TableFlip`` (on the tiny {Li+,
  vacancy} x {Mn3+, Mn4+} cell) give the reference's steps over 300 steps
  of an evolving occupancy, ``compute_log_priori_factor`` its factor within
  1e-12 (TableFlip's gammaln terms), and ``update_aux_state`` /
  ``set_aux_state`` take the reference's arguments;
- ``Metropolis`` and ``UniformlyRandom`` ``single_step`` trajectories over
  600 steps equal the reference's on the bench spinel CE (flips, swaps)
  and on the tiny table-flip cell: occupancies and accept flags equal, the
  delta traces within ``|diff| <= 1e-12 max(1, max |reference|)``;
- the host Wang-Landau on the 8-site Au-Cu (``torch_aucu_nn_2x2x2.npz``)
  gives equal entropy, histogram and occurrences planes, ``levels``,
  ``dos`` and mod factor after 2400 steps.

The port's systems are the committed files exported from the reference's
ensembles (``scripts/export_torch_systems.py``).
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu.capp.generate.random import generate_random_ordered_occupancy
from smol_tpu.moca.kernel.mcusher import Composite as RefComposite
from smol_tpu.moca.kernel.mcusher import Flip as RefFlip
from smol_tpu.moca.kernel.mcusher import MultiStep as RefMultiStep
from smol_tpu.moca.kernel.mcusher import Swap as RefSwap
from smol_tpu.moca.kernel.metropolis import Metropolis as RefMetropolis
from smol_tpu.moca.kernel.metropolis import UniformlyRandom as RefUniform
from smol_tpu.moca.kernel.tableflip import TableFlip as RefTableFlip
from smol_tpu.moca.kernel.wanglandau import WangLandau as RefWangLandau
from smol_tpu.utils.math import choose_section_from_partition as ref_choose
from smol_tpu.utils.math import flip_weights_mask as ref_mask
from smol_tpu_torch.moca.ensemble import Ensemble
from smol_tpu_torch.moca.kernel import (
    Composite,
    Flip,
    Metropolis,
    MultiStep,
    Swap,
    TableFlip,
    UniformlyRandom,
    WangLandau,
)
from smol_tpu_torch.system import load_system
from smol_tpu_torch.utils.math import choose_section_from_partition, flip_weights_mask

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import (  # noqa: E402
    aucu_nn_ensemble,
    data_path,
    limn_tiny_ensemble,
    spinel_ensemble,
)

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(mine, theirs):
    mine, theirs = np.asarray(mine, dtype=np.float64), np.asarray(theirs, dtype=np.float64)
    bound = TOL * max(1.0, float(np.abs(theirs).max(initial=0.0)))
    assert mine.shape == theirs.shape
    assert float(np.abs(mine - theirs).max(initial=0.0)) <= bound


@functools.lru_cache(maxsize=None)
def _systems(stem):
    """(reference ensemble, port ensemble on the CPU) of a committed file."""
    ref = {"spinel_2x2x2": lambda: spinel_ensemble(2), "limn_tiny_2x1x1": limn_tiny_ensemble,
           "aucu_nn_2x2x2": aucu_nn_ensemble}[stem]()
    port = Ensemble.from_system(load_system(data_path(stem)), "cpu")
    return ref, port


def _start(port, seed):
    """A random occupancy of every sublattice's codes."""
    rng = np.random.default_rng(seed)
    occu = np.zeros(port.num_sites, dtype=np.int32)
    for sl in port.sublattices:
        occu[sl.sites] = rng.choice(sl.encoding, size=len(sl.sites))
    return occu


def _neutral_start(ref, seed=2):
    """A charge-neutral occupancy of the tiny cell, drawn by the reference."""
    return np.asarray(generate_random_ordered_occupancy(
        ref.processor, charge_neutral=True, rng=np.random.default_rng(seed)), dtype=np.int32)


def test_math_helpers_equal_reference():
    rng = np.random.default_rng(0)
    table = rng.integers(-2, 3, size=(4, 6))
    for _ in range(20):
        counts = rng.integers(0, 5, size=6)
        for max_n in (None, 4, rng.integers(3, 7, size=6)):
            np.testing.assert_array_equal(flip_weights_mask(table, counts, max_n),
                                          ref_mask(table, counts, max_n))
    for seed in range(20):
        weights = np.random.default_rng(seed).random(7) * (seed % 3 != 0)
        assert choose_section_from_partition(weights, rng=seed) == ref_choose(weights, rng=seed)
    with pytest.raises(ValueError, match="negative"):
        choose_section_from_partition([1.0, -1.0])


def _walk(mine, theirs, occu, steps, priori=False):
    """Propose ``steps`` steps with both ushers from the same occupancy,
    applying each: the steps must be equal (and their log factors)."""
    mine_occ, theirs_occ = occu.copy(), occu.copy()
    for _ in range(steps):
        step = mine.propose_step(mine_occ)
        expect = theirs.propose_step(theirs_occ)
        assert step == [(int(s), int(c)) for s, c in expect]
        if priori:
            _close(mine.compute_log_priori_factor(mine_occ, step),
                   theirs.compute_log_priori_factor(theirs_occ, expect))
        for site, code in step:
            mine_occ[site] = code
            theirs_occ[site] = code
        mine.update_aux_state(step)
        theirs.update_aux_state(expect)
    return mine_occ


@pytest.mark.parametrize("usher", ["flip", "swap", "multi-step", "composite"])
def test_ushers_propose_reference_steps(usher):
    ref, port = _systems("spinel_2x2x2")
    build = {
        "flip": lambda sls, cls: cls[0](sls, rng=5),
        "swap": lambda sls, cls: cls[1](sls, rng=5),
        "multi-step": lambda sls, cls: cls[2](sls, "flip", [1, 2, 3], [0.2, 0.3, 0.5], rng=5),
        "composite": lambda sls, cls: cls[3](sls, ["flip", "swap"], [1, 2], rng=5),
    }[usher]
    mine = build(port.sublattices, (Flip, Swap, MultiStep, Composite))
    theirs = build(ref.sublattices, (RefFlip, RefSwap, RefMultiStep, RefComposite))
    occu = _start(port, 3)
    mine.set_aux_state(occu)
    theirs.set_aux_state(occu)
    assert mine.compute_log_priori_factor(occu, []) == theirs.compute_log_priori_factor(
        occu, []) == 0.0
    _walk(mine, theirs, occu, 300)


def test_tableflip_proposes_reference_steps():
    ref, port = _systems("limn_tiny_2x1x1")
    mine = TableFlip(port.sublattices, rng=9, **port.table_data)
    theirs = RefTableFlip(ref.sublattices, rng=9)
    np.testing.assert_array_equal(mine.flip_table, theirs.flip_table)
    occu = _neutral_start(ref)
    final = _walk(mine, theirs, occu, 300, priori=True)
    np.testing.assert_array_equal(  # every table flip keeps the charge neutral
        port.site_charges[np.arange(port.num_sites), final].sum(), 0.0)
    # a step the table does not hold raises, as the reference's
    site = int(port.sublattices[0].active_sites[0])
    other = [c for c in port.sublattices[0].encoding if c != occu[site]][0]
    with pytest.raises(ValueError, match="not in flip table"):
        mine._match_direction(occu, [(site, int(other))])


KERNEL_CASES = {  # (kernel, step type, system, temperature or None)
    "metropolis-flip-spinel": ("metropolis", "flip", "spinel_2x2x2", 1500.0),
    "metropolis-swap-spinel": ("metropolis", "swap", "spinel_2x2x2", 1500.0),
    "metropolis-table-flip-tiny": ("metropolis", "table-flip", "limn_tiny_2x1x1", 800.0),
    "uniform-flip-spinel": ("uniform", "flip", "spinel_2x2x2", None),
    "uniform-table-flip-tiny": ("uniform", "table-flip", "limn_tiny_2x1x1", None),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_single_step_trajectories_equal_reference(case):
    kind, step_type, stem, temperature = KERNEL_CASES[case]
    ref, port = _systems(stem)
    if kind == "metropolis":
        mine = Metropolis(port, step_type, temperature, seed=21)
        theirs = RefMetropolis(ref, step_type, temperature, seed=21)
    else:
        mine = UniformlyRandom(port, step_type, seed=21)
        theirs = RefUniform(ref, step_type, seed=21)
    occu = _neutral_start(ref) if stem == "limn_tiny_2x1x1" else _start(port, 4)
    mine_occ, theirs_occ = occu.copy(), occu.copy()
    mine.set_aux_state(mine_occ)
    theirs.set_aux_state(theirs_occ)
    _close(mine.compute_initial_trace(mine_occ).enthalpy,
           theirs.compute_initial_trace(theirs_occ).enthalpy)
    accepted = 0
    for _ in range(600):
        trace = mine.single_step(mine_occ)
        expect = theirs.single_step(theirs_occ)
        np.testing.assert_array_equal(mine_occ, theirs_occ)
        assert bool(trace.accepted) == bool(expect.accepted)
        _close(trace.delta_trace.features, expect.delta_trace.features)
        _close(trace.delta_trace.enthalpy, expect.delta_trace.enthalpy)
        accepted += bool(trace.accepted)
    assert 0 < accepted < 600 or kind == "uniform"
    np.testing.assert_array_equal(mine.trace.occupancy, mine_occ)
    if temperature is not None:
        assert float(mine.trace.temperature) == temperature


def test_host_wang_landau_equals_reference():
    ref, port = _systems("aucu_nn_2x2x2")
    system = load_system(data_path("aucu_nn_2x2x2"))
    levels = np.unique(np.round(system["exact_enthalpies"], 9))
    bin_size = float(levels[1] - levels[0])
    window = dict(min_enthalpy=float(levels[0] - bin_size / 2),
                  max_enthalpy=float(levels[-1] + bin_size), bin_size=bin_size)
    mine = WangLandau(port, "flip", **window, check_period=400, seed=31)
    theirs = RefWangLandau(ref, "flip", **window, check_period=400, seed=31)
    occu = _start(port, 6)
    mine_occ, theirs_occ = occu.copy(), occu.copy()
    mine.set_aux_state(mine_occ)
    theirs.set_aux_state(theirs_occ)
    for _ in range(2400):
        trace = mine.single_step(mine_occ)
        expect = theirs.single_step(theirs_occ)
        assert bool(trace.accepted) == bool(expect.accepted)
    np.testing.assert_array_equal(mine_occ, theirs_occ)
    for name in ("histogram", "occurrences"):
        np.testing.assert_array_equal(getattr(mine, f"_{name}"), getattr(theirs, f"_{name}"))
    np.testing.assert_array_equal(mine._entropy, theirs._entropy)
    np.testing.assert_array_equal(mine.levels, theirs.levels)
    np.testing.assert_array_equal(mine.histogram, theirs.histogram)
    _close(mine.dos, theirs.dos)
    _close(mine._mean_features, theirs._mean_features)
    assert mine.mod_factor == theirs.mod_factor < 1.0  # a flat histogram was found
    trace = mine.compute_initial_trace(mine_occ)
    np.testing.assert_array_equal(trace.entropy, theirs.compute_initial_trace(
        theirs_occ).entropy)
    _close(mine._current_enthalpy, float(port.compute_feature_vector(mine_occ)
                                         @ mine.natural_params))
