"""Core model pieces: AER codec, fixed-point numerics, neurons, the RSNN
config and the execution backend."""
