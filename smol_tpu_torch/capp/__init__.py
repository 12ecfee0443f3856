"""Applications of the port: special quasi-random structure generation."""

from smol_tpu_torch.capp.generate.special.sqs import SQS, SQSGenerator, StochasticSQSGenerator

__all__ = ["SQS", "SQSGenerator", "StochasticSQSGenerator"]
