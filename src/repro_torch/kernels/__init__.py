"""Hand-written Hopper kernels, each a kernel/ops/ref triple."""
