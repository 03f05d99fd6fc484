"""Optimizers: the chip's e-prop SGD with fixed-point commits."""
