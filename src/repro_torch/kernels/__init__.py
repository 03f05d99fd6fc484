"""Hand-written CUDA kernels, their plain PyTorch versions, and the
device-dispatching ops (:mod:`repro_torch.kernels.ops`)."""
