"""Multi-replica parallelism: replica exchange (parallel tempering)."""

from smol_tpu_torch.parallel.tempering import (
    ExchangeLaunches,
    exchange_attempts,
    exchange_betas,
    make_temperature_ladder,
    make_tempering_chain,
    make_tempering_step,
    tempering_exchange,
)

__all__ = [
    "make_temperature_ladder",
    "tempering_exchange",
    "exchange_betas",
    "exchange_attempts",
    "ExchangeLaunches",
    "make_tempering_chain",
    "make_tempering_step",
]
