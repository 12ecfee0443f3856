"""Special structures: the stochastic SQS generator."""
