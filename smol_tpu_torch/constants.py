"""Physical constants (counterpart of smol_tpu/constants.py)."""

kB = 8.617333262145e-5  # Boltzmann constant in eV/K (2018 CODATA)
