"""The port's processors, built as the reference builds them, against smol_tpu's.

``ClusterExpansionProcessor``, ``ClusterDecompositionProcessor``,
``EwaldProcessor`` and their ``CompositeProcessor`` take ``(subspace,
supercell matrix, coefficients)`` in both packages.  On the same inputs
(occupancies and flip lists of 1 to 3 flips drawn from a numpy seed) the
port's host API must give the reference's answers: feature vectors,
feature changes and properties within 1e-12 relative (|diff| <= 1e-12 *
max(1, max |reference|)), the same encoded and decoded occupancies and the
same ordered structures.  The systems are the bench spinel CE + Ewald on
2x2x2 (every processor) and the golden LNO expansion of
``tests/data/golden_lno_ce.json`` on one of its supercells (the expansion
and the decomposition), and bench ``sqs``'s fcc expansion on 1x1x1 and
1x1x2, whose clusters hold a site more than once (the local delta then
changes every slot of the site).  A reference processor's ``as_dict``
loads in the port (``Processor.from_dict``), and the port's, its modules
named as the reference's, loads in the reference.
"""

import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from smol_tpu.serial import SmolJSONEncoder

from smol_tpu_torch.benchmarks.systems import random_expansion, spinel_prim
from smol_tpu_torch.cofe import ClusterExpansion, ClusterSubspace
from smol_tpu_torch.crystal.pmg_compat import load_pmg_json
from smol_tpu_torch.moca.processor.base import Processor
from smol_tpu_torch.moca.processor.composite import CompositeProcessor
from smol_tpu_torch.moca.processor.ewald import EwaldProcessor
from smol_tpu_torch.moca.processor.expansion import (
    ClusterDecompositionProcessor,
    ClusterExpansionProcessor,
)
from smol_tpu_torch.serial import SmolJSONEncoder as PortEncoder

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from export_torch_systems import reference_native  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
REL_TOL = 1e-12
SPINEL_CELL = np.diag([2, 2, 2])


def _close(mine, theirs, what):
    mine, theirs = np.asarray(mine, dtype=np.float64), np.asarray(theirs, dtype=np.float64)
    assert mine.shape == theirs.shape, what
    diff = float(np.abs(mine - theirs).max(initial=0.0))
    assert diff <= REL_TOL * max(1.0, float(np.abs(theirs).max(initial=0.0))), (what, diff)


def _processors(mine, theirs, scm):
    """{kind: (port processor, reference processor)} of two expansions'
    subspaces (with their Ewald term, where they have one)."""
    from smol_tpu.moca.processor import CompositeProcessor as RefComposite
    from smol_tpu.moca.processor import EwaldProcessor as RefEwald
    from smol_tpu.moca.processor.expansion import (
        ClusterDecompositionProcessor as RefDecomposition,
    )
    from smol_tpu.moca.processor.expansion import ClusterExpansionProcessor as RefExpansion

    out = {}
    pairs = ((mine, ClusterExpansionProcessor, ClusterDecompositionProcessor, EwaldProcessor,
              CompositeProcessor, {"device": "cpu"}),
             (theirs, RefExpansion, RefDecomposition, RefEwald, RefComposite, {}))
    for ce, expansion, decomposition, ewald, composite, kw in pairs:
        subspace = ce.cluster_subspace
        n_ext = len(subspace.external_terms)
        made = {
            "expansion": expansion(subspace, scm, ce.coefs[:len(ce.coefs) - n_ext], **kw),
            "decomposition": decomposition(subspace, scm, ce.cluster_interaction_tensors,
                                           **kw),
        }
        if n_ext:
            made["ewald"] = ewald(subspace, scm, ewald_term=subspace.external_terms[0],
                                  coefficient=ce.coefs[-1], **kw)
            made["composite"] = composite(subspace, scm, **kw)
            made["composite"].add_processor(decomposition(
                subspace, scm, ce.cluster_interaction_tensors, **kw))
            made["composite"].add_processor(made["ewald"])
        for kind, processor in made.items():
            out.setdefault(kind, []).append(processor)
    return {kind: tuple(pair) for kind, pair in out.items()}


@functools.lru_cache(maxsize=None)
def _spinel_expansion():
    """The port's bench spinel CE + Ewald."""
    return random_expansion(spinel_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True)


@functools.lru_cache(maxsize=None)
def _spinel():
    from smol_tpu.benchmarks.systems import random_expansion as ref_expansion
    from smol_tpu.benchmarks.systems import spinel_prim as ref_prim

    reference_native()  # the Ewald sums of the committed files
    return _processors(
        _spinel_expansion(),
        ref_expansion(ref_prim(), {2: 5.3, 3: 3.7}, seed=11, ewald=True), SPINEL_CELL)


@functools.lru_cache(maxsize=None)
def _lno():
    from smol_tpu.cofe import ClusterExpansion as RefExpansion
    from smol_tpu.cofe import ClusterSubspace as RefSubspace
    from smol_tpu.crystal.pmg_compat import load_pmg_json as ref_load

    golden = json.loads((DATA / "golden_lno_ce.json").read_text())
    cutoffs = {int(k): v for k, v in golden["construction"]["cutoffs"].items()}
    basis = golden["construction"]["basis"]
    coefs = np.asarray(golden["coefs"])
    mine = ClusterSubspace.from_cutoffs(load_pmg_json(str(DATA / "lno_prim.json")), cutoffs,
                                        basis=basis)
    theirs = RefSubspace.from_cutoffs(ref_load(str(DATA / "lno_prim.json")), cutoffs,
                                      basis=basis)
    scm = np.asarray(golden["entries"][3]["supercell_matrix"])
    return _processors(ClusterExpansion(mine, coefs), RefExpansion(theirs, coefs), scm)


@functools.lru_cache(maxsize=None)
def _fcc(cell):
    """Bench ``sqs``'s fcc Au-Cu expansion on a cell so small that its
    clusters hold a site more than once."""
    from smol_tpu.benchmarks.systems import fcc_binary_prim as ref_prim
    from smol_tpu.benchmarks.systems import random_expansion as ref_expansion

    from smol_tpu_torch.benchmarks.systems import fcc_binary_prim

    return _processors(random_expansion(fcc_binary_prim(), {2: 5.0, 3: 3.5}, seed=3),
                       ref_expansion(ref_prim(), {2: 5.0, 3: 3.5}, seed=3), np.diag(cell))


CASES = [("spinel", kind) for kind in ("expansion", "decomposition", "ewald", "composite")] \
    + [(system, kind) for system in ("lno", "fcc111", "fcc112")
       for kind in ("expansion", "decomposition")]


def _pair(system, kind):
    return {"spinel": _spinel, "lno": _lno, "fcc111": functools.partial(_fcc, (1, 1, 1)),
            "fcc112": functools.partial(_fcc, (1, 1, 2))}[system]()[kind]


def _occupancies(processor, count, seed):
    rng = np.random.default_rng(seed)
    codes = np.array([len(species) for species in processor.allowed_species])
    return (rng.random((count, len(codes))) * codes).astype(np.int32)


def _flips(processor, occupancy, length, rng):
    """``length`` flips of active sites to another of their codes."""
    codes = np.array([len(species) for species in processor.allowed_species])
    active = np.flatnonzero(codes > 1)
    flips = []
    for site in rng.choice(active, size=length, replace=False):
        new = (occupancy[site] + rng.integers(1, codes[site])) % codes[site]
        flips.append((int(site), int(new)))
    return flips


@pytest.mark.parametrize("system,kind", CASES)
def test_features_and_changes_equal_reference(system, kind):
    """Feature vectors, feature changes of 1 to 3 flips (applied in order;
    at most one a site) and properties, within 1e-12 relative; each change
    also against the port's own full recompute."""
    mine, theirs = _pair(system, kind)
    assert type(mine).__name__ == type(theirs).__name__
    assert (mine.size, mine.num_sites, len(mine)) == (theirs.size, theirs.num_sites, len(theirs))
    np.testing.assert_array_equal(mine.coefs, theirs.coefs)
    rng = np.random.default_rng(7)
    for occupancy in _occupancies(mine, 3, seed=1):
        features = mine.compute_feature_vector(occupancy)
        _close(features, theirs.compute_feature_vector(occupancy), "features")
        _close(mine.compute_property(occupancy), theirs.compute_property(occupancy),
               "property")
        for length in (1, 2, 3)[:mine.num_sites]:
            flips = _flips(mine, occupancy, length, rng)
            change = mine.compute_feature_vector_change(occupancy, flips)
            _close(change, theirs.compute_feature_vector_change(occupancy, flips), "change")
            _close(mine.compute_property_change(occupancy, flips),
                   theirs.compute_property_change(occupancy, flips), "property change")
            after = occupancy.copy()
            for site, code in flips:
                after[site] = code
            full = mine.compute_feature_vector(after) - features
            assert float(np.abs(change - full).max()) <= REL_TOL * max(
                1.0, float(np.abs(features).max())), "against the full recompute"


@pytest.mark.parametrize("system", ["spinel", "lno"])
def test_occupancy_codes_and_structures_equal_reference(system):
    """Encoded and decoded occupancies, the default sublattices and the
    ordered structures are the reference's."""
    mine, theirs = _pair(system, "expansion")
    assert [[str(sp) for sp in species] for species in mine.allowed_species] == \
        [[str(sp) for sp in species] for species in theirs.allowed_species]
    assert len(mine.unique_site_spaces) == len(theirs.unique_site_spaces)
    assert len(mine.active_site_spaces) == len(theirs.active_site_spaces)
    for sl, ref_sl in zip(mine.get_sublattices(), theirs.get_sublattices()):
        np.testing.assert_array_equal(sl.sites, ref_sl.sites)
        np.testing.assert_array_equal(sl.active_sites, ref_sl.active_sites)
        assert [str(sp) for sp in sl.species] == [str(sp) for sp in ref_sl.species]
    for occupancy in _occupancies(mine, 2, seed=3):
        decoded = mine.decode_occupancy(occupancy)
        assert [str(sp) for sp in decoded] == \
            [str(sp) for sp in theirs.decode_occupancy(occupancy)]
        np.testing.assert_array_equal(mine.encode_occupancy(decoded), occupancy)
        structure = mine.structure_from_occupancy(occupancy)
        ref_structure = theirs.structure_from_occupancy(occupancy)
        assert len(structure) == len(ref_structure)
        np.testing.assert_allclose(structure.lattice.matrix, ref_structure.lattice.matrix,
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(structure.frac_coords, ref_structure.frac_coords,
                                   rtol=0, atol=1e-12)
        assert [str(s.specie) for s in structure] == [str(s.specie) for s in ref_structure]
        np.testing.assert_array_equal(mine.occupancy_from_structure(structure), occupancy)


def _renamed(doc, old, new):
    """A saved document with its ``@module`` tags moved from ``old`` to
    ``new``."""
    if isinstance(doc, dict):
        doc = {k: _renamed(v, old, new) for k, v in doc.items()}
        module = doc.get("@module")
        if isinstance(module, str) and (module == old or module.startswith(old + ".")):
            doc["@module"] = new + module[len(old):]
        return doc
    if isinstance(doc, list):
        return [_renamed(v, old, new) for v in doc]
    return doc


@pytest.mark.parametrize("kind", ["expansion", "decomposition", "ewald", "composite"])
def test_saved_processors_load_both_ways(kind):
    """The reference's ``as_dict`` JSON loads into the port, and the port's
    into the reference, each evaluating the same features."""
    from smol_tpu.moca.processor import Processor as RefProcessor

    mine, theirs = _pair("spinel", kind)
    ref_doc = json.loads(json.dumps(theirs.as_dict(), cls=SmolJSONEncoder))
    loaded = Processor.from_dict(ref_doc, device="cpu")
    assert type(loaded) is type(mine)
    port_doc = json.loads(json.dumps(mine.as_dict(), cls=PortEncoder))
    assert port_doc["@module"].startswith("smol_tpu_torch.")
    back = RefProcessor.from_dict(_renamed(port_doc, "smol_tpu_torch", "smol_tpu"))
    assert type(back) is type(theirs)
    for occupancy in _occupancies(mine, 2, seed=5):
        expect = theirs.compute_feature_vector(occupancy)
        _close(loaded.compute_feature_vector(occupancy), expect, "port from reference")
        _close(back.compute_feature_vector(occupancy), expect, "reference from port")


def test_loaded_processor_has_no_structure():
    """A processor loaded from a system dict evaluates the same features and
    refuses what needs the subspace, saying why."""
    from smol_tpu_torch.system import build_system

    mine, _ = _pair("spinel", "decomposition")
    system = build_system(_spinel_expansion(), SPINEL_CELL)
    loaded = ClusterDecompositionProcessor.from_system(system, "cpu")
    assert loaded.cluster_subspace is None and loaded.structure is None
    occupancy = _occupancies(mine, 1, seed=2)[0]
    np.testing.assert_array_equal(loaded.compute_feature_vector(occupancy),
                                  mine.compute_feature_vector(occupancy))
    for call in (lambda: loaded.structure_from_occupancy(occupancy),
                 lambda: loaded.decode_occupancy(occupancy), loaded.as_dict):
        with pytest.raises(ValueError, match="subspace"):
            call()

