"""MC kernels, ushers and biases (counterpart of ``smol_tpu/moca/kernel``)."""

from smol_tpu_torch.moca.kernel.base import (
    ChainKernel,
    MCKernel,
    MCKernelInterface,
    StandardSingleStepMixin,
    ThermalKernelMixin,
)
from smol_tpu_torch.moca.kernel.bias import (
    FugacityBias,
    MCBias,
    SquareChargeBias,
    SquareHyperplaneBias,
    available_bias_types,
    mcbias_factory,
)
from smol_tpu_torch.moca.kernel.mcusher import (
    Composite,
    Flip,
    MCUsher,
    MultiStep,
    Swap,
    available_step_types,
    mcusher_factory,
)
from smol_tpu_torch.moca.kernel.metropolis import Metropolis, UniformlyRandom, mckernel_factory
from smol_tpu_torch.moca.kernel.multicell import MulticellKernel, MulticellMetropolis
from smol_tpu_torch.moca.kernel.tableflip import TableFlip
from smol_tpu_torch.moca.kernel.wanglandau import WangLandau
from smol_tpu_torch.utils.class_utils import get_subclasses

__all__ = [
    "MCKernel",
    "MCKernelInterface",
    "StandardSingleStepMixin",
    "ChainKernel",
    "ThermalKernelMixin",
    "Metropolis",
    "UniformlyRandom",
    "WangLandau",
    "MulticellKernel",
    "MulticellMetropolis",
    "MCUsher",
    "Flip",
    "Swap",
    "MultiStep",
    "Composite",
    "TableFlip",
    "MCBias",
    "FugacityBias",
    "SquareChargeBias",
    "SquareHyperplaneBias",
    "mckernel_factory",
    "mcusher_factory",
    "mcbias_factory",
    "available_mckernels",
    "available_step_types",
    "available_bias_types",
]


def available_mckernels() -> tuple:
    """Names of the MC kernel types: the single-cell kernels and the
    multicell ones (the reference's ``kernel/__init__.py:66-79``); the
    port's ``ChainKernel`` is a base, not a kernel type."""
    single = (name for name in get_subclasses(MCKernel) if name != "ChainKernel")
    return tuple(single) + tuple(get_subclasses(MulticellKernel))
