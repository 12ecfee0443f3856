"""Port features against ``smol_tpu``'s on the same occupancies.

The port's full feature vector (extensive correlations plus the chemical
work) must equal ``Ensemble.compute_feature_vector`` of the reference to
1e-12 relative (|diff| <= 1e-12 * max(1, max |feature|)): both sum the
same f64 terms, in different orders.  Checked on 32 random occupancies
of the bench spinel and of an LNO ensemble built from the golden
reference expansion ``tests/data/golden_lno_ce.json``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from smol_tpu_torch.moca.ensemble import Ensemble as TorchEnsemble
from smol_tpu_torch.moca.ensemble import random_occupancies
from smol_tpu_torch.ops.correlations import corr_from_occupancy
from smol_tpu_torch.system import export_system, load_system

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parent / "scripts"))
from export_torch_systems import system_path  # noqa: E402

REL_TOL = 1e-12


def _assert_features_match(ref_ensemble, port_ensemble, seed):
    occ = random_occupancies(ref_ensemble, 32, seed)
    ref = np.array([ref_ensemble.compute_feature_vector(o) for o in occ])
    mine = port_ensemble.compute_features(torch.as_tensor(occ)).numpy()
    assert mine.dtype == np.float64 and mine.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(mine - ref).max() <= REL_TOL * scale
    ncorr = port_ensemble.processor.num_corr
    for o, row in zip(occ[:4], mine[:4]):
        np.testing.assert_array_equal(port_ensemble.compute_feature_vector(o), row)
        np.testing.assert_array_equal(
            port_ensemble.processor.compute_feature_vector(o), row[:ncorr]
        )


def _lno_ensemble():
    from smol_tpu.cofe import ClusterExpansion, ClusterSubspace
    from smol_tpu.crystal.pmg_compat import load_pmg_json
    from smol_tpu.moca import Ensemble

    data = ROOT / "data"
    golden = json.loads((data / "golden_lno_ce.json").read_text())
    prim = load_pmg_json(str(data / "lno_prim.json"))
    cs = ClusterSubspace.from_cutoffs(prim, {2: 5, 3: 4.1}, basis="sinusoid")
    ce = ClusterExpansion(cs, np.asarray(golden["coefs"], dtype=np.float64))
    scm = np.asarray(golden["entries"][0]["supercell_matrix"])
    return Ensemble.from_cluster_expansion(ce, scm, processor_type="expansion")


def test_spinel_features_match_reference():
    from export_torch_systems import spinel_ensemble

    ref = spinel_ensemble(2)
    port = TorchEnsemble.from_system(load_system(system_path("2x2x2")), "cpu")
    assert port.num_sites == ref.num_sites
    np.testing.assert_array_equal(port.natural_parameters, ref.natural_parameters)
    _assert_features_match(ref, port, seed=1)


@pytest.mark.parametrize("mu", [False, True])
def test_lno_features_match_reference(mu):
    ref = _lno_ensemble()
    if mu:
        species = ref.species
        ref.chemical_potentials = {
            sp: 0.03 * (i - 1) for i, sp in enumerate(species)
        }
    port = TorchEnsemble.from_system(export_system(ref), "cpu")
    assert len(port.natural_parameters) == len(ref.natural_parameters)
    _assert_features_match(ref, port, seed=2)


def test_corr_of_single_occupancy_broadcasts():
    port = TorchEnsemble.from_system(load_system(system_path("2x2x2")), "cpu")
    occ = torch.zeros(port.num_sites, dtype=torch.int32)
    one = corr_from_occupancy(occ, port.processor.packed)
    batch = corr_from_occupancy(occ[None].expand(3, -1), port.processor.packed)
    assert one.shape == (1, port.processor.num_corr)
    assert torch.equal(batch, one.expand(3, -1))
    assert float(one[0, 0]) == 1.0
