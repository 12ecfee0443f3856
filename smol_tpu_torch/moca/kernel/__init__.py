"""MC kernels, ushers and biases (counterpart of ``smol_tpu/moca/kernel``)."""

from smol_tpu_torch.moca.kernel.base import ChainKernel, MCKernel, ThermalKernelMixin
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
from smol_tpu_torch.moca.kernel.tableflip import TableFlip
from smol_tpu_torch.moca.kernel.wanglandau import WangLandau

__all__ = [
    "MCKernel",
    "ChainKernel",
    "ThermalKernelMixin",
    "Metropolis",
    "UniformlyRandom",
    "WangLandau",
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
    "available_step_types",
    "available_bias_types",
]
