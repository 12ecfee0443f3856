"""Measure two faults of smol_tpu that the port's per-step path does not inherit.

C10: the reference's per-step Wang-Landau (``smol_tpu/ops/mc.py:_wl_step``,
built by ``WangLandau.make_step_fn``) leaves the usher's a-priori factor out
of its exponent, so a ``table-flip`` Wang-Landau is not detailed-balanced.
Both packages run it on the tiny {Li+, vacancy} x {Mn3+, Mn4+} cell, whose
charge-neutral states are enumerated: the log-DOS error of every walker
against the exact degeneracies (bins of 2 meV), the reference's and the
port's (which adds the factor).

C11: the reference's chain tables check the encodings of the active
sublattices only and read a frozen site as code 0, so after splitting a
ternary FCC sublattice into [[0, 1], [2]] its swap chain (in Pallas
interpret mode on the CPU) sums the wrong clusters: the recorded enthalpy
against features . theta.  The port refuses the split system on its chains
and runs it on the per-step path, where the same check holds to roundoff.

Run: ``JAX_PLATFORMS=cpu python scripts/reference_step_path_faults.py``
(a few minutes on a CPU).
"""

import os
import sys
from itertools import product
from pathlib import Path

import numpy as np

os.environ.setdefault("SMOL_TPU_CHAIN_INTERPRET", "1")  # the reference's chain on a CPU
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

from export_torch_systems import data_path, limn_tiny_ensemble  # noqa: E402
from smol_tpu.benchmarks.systems import fcc_ternary_prim, random_expansion  # noqa: E402
from smol_tpu.moca import Ensemble as RefEnsemble  # noqa: E402
from smol_tpu.moca import Sampler as RefSampler  # noqa: E402
from smol_tpu_torch.benchmarks import systems as port_systems  # noqa: E402
from smol_tpu_torch.moca.ensemble import Ensemble  # noqa: E402
from smol_tpu_torch.moca.sampler.sampler import Sampler  # noqa: E402
from smol_tpu_torch.system import load_system  # noqa: E402

WALKERS, STEPS, BIN = 16, 3000, 0.002


def neutral_states(port):
    n = port.num_sites
    codes = {s: sl.encoding for sl in port.sublattices for s in sl.sites}
    states = np.array(list(product(*(codes[s] for s in range(n)))), dtype=np.int32)
    return states[port.site_charges[np.arange(n), states].sum(axis=1) == 0]


def dos_errors(entropy, energies, lo):
    dos = np.bincount(np.floor((energies - lo) / BIN).astype(int), minlength=entropy.shape[1])
    seen = dos > 0
    estimate = entropy[:, seen] - entropy[:, seen][:, :1]
    exact = np.log(dos[seen]) - np.log(dos[seen][0])
    return np.abs(estimate - exact).max(axis=1)


def c10():
    port = Ensemble.from_system(load_system(data_path("limn_tiny_2x1x1")), "cpu")
    states = neutral_states(port)
    energies = (port.compute_features(torch.as_tensor(states))
                @ torch.as_tensor(port.natural_parameters)).numpy()
    lo = float(energies.min() - BIN / 2)
    bins = int(np.ceil((energies.max() - lo) / BIN)) + 1
    window = dict(min_enthalpy=lo, max_enthalpy=lo + bins * BIN, bin_size=BIN,
                  flatness=0.8, check_period=200, nwalkers=WALKERS)
    for name, sampler in (
            ("smol_tpu", RefSampler.from_ensemble(limn_tiny_ensemble(), kernel_type="wang-landau",
                                                  step_type="table-flip", seed=3, **window)),
            ("port", Sampler.from_ensemble(port, kernel_type="wang-landau", device="cpu",
                                           step_type="table-flip", seed=3, **window))):
        sampler.run(STEPS, np.tile(states[0], (WALKERS, 1)), thin_by=STEPS // 3)
        entropy = np.asarray(sampler.samples.get_trace_value("entropy", flat=False))[-1]
        errors = dos_errors(entropy, energies, lo)
        print(f"C10 [{name}] table-flip Wang-Landau on limn_tiny_2x1x1, {WALKERS} walkers x "
              f"{STEPS} steps: log-DOS error median {np.median(errors):.4f}, worst "
              f"{errors.max():.4f} (the visited levels' degeneracies "
              f"{[int(d) for d in np.bincount(np.floor((energies - lo) / BIN).astype(int)) if d]})")


def c11():
    occ = (np.arange(8) % 3).astype(np.int32)
    ref = RefEnsemble.from_cluster_expansion(
        random_expansion(fcc_ternary_prim(), {2: 5.5, 3: 4.0}, seed=7), np.diag([2, 2, 2]))
    port = Ensemble.from_cluster_expansion(
        port_systems.random_expansion(port_systems.fcc_ternary_prim(), {2: 5.5, 3: 4.0},
                                      seed=7), np.diag([2, 2, 2]), device="cpu")
    for name, ens, sampler_of in (
            ("smol_tpu", ref, lambda e: RefSampler.from_ensemble(e, temperature=2000.0,
                                                               nwalkers=8, seed=8)),
            ("port", port, lambda e: Sampler.from_ensemble(e, 2000.0, nwalkers=8, seed=8,
                                                           device="cpu"))):
        ens.split_sublattice_by_species(0, occ, [[0, 1], [2]])
        sampler = sampler_of(ens)
        path = sampler.execution_path(10)
        sampler.run(200, np.tile(occ, (8, 1)), thin_by=10)
        f, h = sampler.samples.get_feature_vectors(), sampler.samples.get_enthalpies()
        print(f"C11 [{name}] ternary FCC 2x2x2 split [[0, 1], [2]], path {path}: recorded "
              f"enthalpy against features . theta over 200 steps "
              f"{np.abs(f @ ens.natural_parameters - h).max():.3e} eV")


if __name__ == "__main__":
    c10()
    c11()
