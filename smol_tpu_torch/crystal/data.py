"""Periodic table data: atomic numbers and Pauling electronegativities.

Counterpart of ``smol_tpu/crystal/data.py``, whose code it copies. In this
module "the reference" is smol (CederGroupHub/smol).

Replaces the element data of the reference's pymatgen dependency
(pymatgen.core.periodic_table) with an embedded minimal table.  Sorting of
species — which fixes the integer encoding of site spaces, mirroring
smol/cofe/space/domain.py:158 — orders by (electronegativity, symbol,
oxidation state), so the X values here define encoding order.

Electronegativities are Pauling-scale values; elements with no defined
value (noble gases, some actinides) use ``None`` and sort after all
elements with defined X (matching pymatgen's effective NaN-last behavior
for practical site spaces).
"""

# symbol: (atomic number Z, Pauling electronegativity X or None)
ELEMENT_DATA = {
    "H": (1, 2.20), "He": (2, None),
    "Li": (3, 0.98), "Be": (4, 1.57), "B": (5, 2.04), "C": (6, 2.55),
    "N": (7, 3.04), "O": (8, 3.44), "F": (9, 3.98), "Ne": (10, None),
    "Na": (11, 0.93), "Mg": (12, 1.31), "Al": (13, 1.61), "Si": (14, 1.90),
    "P": (15, 2.19), "S": (16, 2.58), "Cl": (17, 3.16), "Ar": (18, None),
    "K": (19, 0.82), "Ca": (20, 1.00), "Sc": (21, 1.36), "Ti": (22, 1.54),
    "V": (23, 1.63), "Cr": (24, 1.66), "Mn": (25, 1.55), "Fe": (26, 1.83),
    "Co": (27, 1.88), "Ni": (28, 1.91), "Cu": (29, 1.90), "Zn": (30, 1.65),
    "Ga": (31, 1.81), "Ge": (32, 2.01), "As": (33, 2.18), "Se": (34, 2.55),
    "Br": (35, 2.96), "Kr": (36, 3.00),
    "Rb": (37, 0.82), "Sr": (38, 0.95), "Y": (39, 1.22), "Zr": (40, 1.33),
    "Nb": (41, 1.60), "Mo": (42, 2.16), "Tc": (43, 1.90), "Ru": (44, 2.20),
    "Rh": (45, 2.28), "Pd": (46, 2.20), "Ag": (47, 1.93), "Cd": (48, 1.69),
    "In": (49, 1.78), "Sn": (50, 1.96), "Sb": (51, 2.05), "Te": (52, 2.10),
    "I": (53, 2.66), "Xe": (54, 2.60),
    "Cs": (55, 0.79), "Ba": (56, 0.89), "La": (57, 1.10), "Ce": (58, 1.12),
    "Pr": (59, 1.13), "Nd": (60, 1.14), "Pm": (61, None), "Sm": (62, 1.17),
    "Eu": (63, None), "Gd": (64, 1.20), "Tb": (65, None), "Dy": (66, 1.22),
    "Ho": (67, 1.23), "Er": (68, 1.24), "Tm": (69, 1.25), "Yb": (70, None),
    "Lu": (71, 1.27), "Hf": (72, 1.30), "Ta": (73, 1.50), "W": (74, 2.36),
    "Re": (75, 1.90), "Os": (76, 2.20), "Ir": (77, 2.20), "Pt": (78, 2.28),
    "Au": (79, 2.54), "Hg": (80, 2.00), "Tl": (81, 1.62), "Pb": (82, 2.33),
    "Bi": (83, 2.02), "Po": (84, 2.00), "At": (85, 2.20), "Rn": (86, None),
    "Fr": (87, 0.70), "Ra": (88, 0.90), "Ac": (89, 1.10), "Th": (90, 1.30),
    "Pa": (91, 1.50), "U": (92, 1.38), "Np": (93, 1.36), "Pu": (94, 1.28),
    "Am": (95, 1.13), "Cm": (96, 1.28), "Bk": (97, 1.30), "Cf": (98, 1.30),
    "Es": (99, 1.30), "Fm": (100, 1.30), "Md": (101, 1.30), "No": (102, 1.30),
    "Lr": (103, None),
}

# electronegativity used as sorting key when X is undefined: sorts after every
# defined element but before vacancies (which use +inf).
UNDEFINED_X = 1.0e6
