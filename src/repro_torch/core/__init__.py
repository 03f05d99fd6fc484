"""Core model pieces: AER codec, fixed-point numerics, neurons, the RSNN
config, e-prop, the execution backend and the online-learning
controller."""
