"""Structure generation: random ordered occupancies and SQS."""
