"""Multi-replica parallelism: replica exchange (parallel tempering)."""

from smol_tpu_torch.parallel.tempering import (
    ExchangeLaunches,
    exchange_attempts,
    exchange_betas,
    exchange_betas_reference,
    make_temperature_ladder,
    make_tempering_chain,
    make_tempering_step,
    tempering_exchange,
)

__all__ = [
    "make_temperature_ladder",
    "tempering_exchange",
    "exchange_betas",
    "exchange_betas_reference",
    "exchange_attempts",
    "ExchangeLaunches",
    "make_tempering_chain",
    "make_tempering_step",
]
