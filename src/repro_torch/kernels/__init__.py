"""Hand-written Hopper kernels, their plain versions, and device dispatch."""
