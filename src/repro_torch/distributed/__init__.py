"""Durable state of the port: atomic, asynchronous checkpoints."""
