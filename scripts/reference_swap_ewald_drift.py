"""Recorded enthalpy against features . theta on the canonical Ewald swap chain.

Runs the reference's interpret-mode Pallas swap chain
(``smol_tpu.ops.pallas_chain``, ``move="swap"``) on the spinel CE + Ewald
and the port's hash-mode twin fed the same pair sequences and seeds, and
prints for each the largest |recorded enthalpy - features . theta| over
the walkers: parity (e), whose contract is < 1e-9.  The reference takes
the Ewald dots in f32 (``ewald_delta``), so its accumulated enthalpy
drifts; the port's are f64.  CPU only, about a minute:

    JAX_PLATFORMS=cpu python scripts/reference_swap_ewald_drift.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CELLS = {(2, 1, 1): 1000, (2, 2, 2): 400}  # supercell -> steps
WALKERS = 64


def main():
    import jax
    import jax.numpy as jnp
    import torch

    from smol_tpu.benchmarks.systems import random_expansion, spinel_prim
    from smol_tpu.moca import Ensemble, Sampler
    from smol_tpu.ops import pallas_chain
    from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
    from smol_tpu_torch.moca.ensemble import random_occupancies
    from smol_tpu_torch.ops import chain
    from smol_tpu_torch.system import export_system

    ce = random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True)
    for cell, n_steps in CELLS.items():
        ref = Ensemble.from_cluster_expansion(ce, np.diag(cell), processor_type="expansion")
        port = TorchEnsemble.from_system(export_system(ref), "cpu")
        occ0 = random_occupancies(ref, WALKERS, 0)
        state = dict(Sampler.from_ensemble(ref, temperature=1000.0, nwalkers=WALKERS,
                                           seed=3).setup_sample(occ0))
        state.pop("words", None)
        state["occupancy"] = jnp.asarray(occ0)
        ref_tables = pallas_chain.build_chain_tables(ref.processor, ref.sublattices)
        key = jax.random.key(0)
        # the reference wrapper's own draws (pallas_chain.py:2054-2068)
        k_seed, k_seq = jax.random.split(jax.random.fold_in(key, 13))
        seed0 = jax.random.randint(k_seed, (), 0, np.int32(2**30 - 1), dtype=jnp.int32)
        useq, vseq = pallas_chain.rank_pair_sequence(ref_tables, k_seq, (1, 1, n_steps))
        out = pallas_chain.make_shared_proposal_chain(
            ref_tables, n_steps, block_size=WALKERS, interpret=True, move="swap"
        )(state, key)

        tables = chain.build_chain_tables(port.processor, port.sublattices)
        port_state = {
            "occupancy": torch.as_tensor(occ0).clone(),
            "enthalpy": torch.tensor(np.array(state["enthalpy"])),
            "beta": torch.tensor(np.array(state["beta"])),
            "naccept": torch.zeros(WALKERS, dtype=torch.int32),
            "accepted": torch.ones(WALKERS, dtype=torch.bool),
        }
        port_state = chain.make_shared_proposal_chain(
            tables, n_steps, block_size=WALKERS, rng="hash", move="swap",
            seqs=(np.array(useq), np.array(vseq)), seeds=[int(seed0)],
        )(port_state, None)

        theta = ref.natural_parameters
        ref_occ = np.asarray(out["occupancy"])
        ref_exact = np.array([ref.compute_feature_vector(o) @ theta for o in ref_occ])
        ref_drift = np.abs(np.asarray(out["enthalpy"]) - ref_exact).max()
        port_exact = (port.compute_features(port_state["occupancy"])
                      @ torch.as_tensor(port.natural_parameters)).numpy()
        port_drift = np.abs(port_state["enthalpy"].numpy() - port_exact).max()
        same = np.mean(np.all(port_state["occupancy"].numpy() == ref_occ, axis=1))
        print(f"spinel CE + Ewald {'x'.join(map(str, cell))}, {WALKERS} walkers x "
              f"{n_steps} swaps, mean accepted "
              f"{float(np.asarray(out['naccept']).mean()):.1f}, max |H| "
              f"{np.abs(ref_exact).max():.1f} eV: |recorded - features.theta| "
              f"reference {ref_drift:.3e} eV, port {port_drift:.3e} eV; "
              f"walkers with the same trajectory {same:.3f}")


if __name__ == "__main__":
    main()
