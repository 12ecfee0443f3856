"""smol_tpu_torch: the PyTorch and CUDA port of smol_tpu.

A second package beside the JAX reference, written for one NVIDIA Hopper
card.  It mirrors ``smol_tpu``'s module layout so that each module's
counterpart is found under the same path.  The cluster-expansion system
crosses over as data (:mod:`smol_tpu_torch.system`): the port imports
neither ``jax`` nor ``smol_tpu``.

Conventions: every function takes an explicit ``device``; no global torch
default (dtype or device) is set; randomness comes from explicit
``torch.Generator`` objects; energies and features are float64, indices
int32.
"""

__version__ = "0.1.0"
