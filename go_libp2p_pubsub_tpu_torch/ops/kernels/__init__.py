"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) and, beside each,
its plain PyTorch version.  A wrapper launches its kernel for CUDA
tensors and runs the plain version only for CPU tensors."""
