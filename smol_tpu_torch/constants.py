"""Physical constants (counterpart of smol_tpu/constants.py)."""

kB = 8.617333262145e-5  # Boltzmann constant in eV/K (2018 CODATA)

SITE_TOL = 1e-6  # absolute tolerance for fractional-coordinate site matching
