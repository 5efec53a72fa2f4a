"""NVIDIA H100 SXM5 80 GB constants: the port's target card, and the
cluster it is deployed in.

The card's figures are from NVIDIA's H100 Tensor Core GPU data sheet (the
SXM column; tensor-core rates without sparsity). The node's are from the
NVIDIA DGX H100 data sheet, and the scalable unit's from the NVIDIA DGX
SuperPOD reference architecture (DGX H100). The per-link interconnect rate
is the data sheet's NVLink total over the card's 18 fourth-generation
links, in one direction: what one worker's upload moves over one link.
"""

# bf16 tensor-core peak, dense (the data sheet lists 1,979 TFLOP/s with
# 2:4 sparsity, half of it dense)
PEAK_FLOPS_BF16 = 989e12
# HBM3 bandwidth: 3.35 TB/s
HBM_BW = 3.35e12
# NVLink: 900 GB/s a card, both directions over 18 links -> 50 GB/s a link
# both ways, 25 GB/s a link each way
NVLINK_LINKS = 18
NVLINK_LINK_BW = 900e9 / NVLINK_LINKS / 2
# NVLink a card, one direction: the data sheet's 900 GB/s counts both
NVLINK_BW = 900e9 / 2
# HBM capacity: 80 GB
HBM_BYTES = 80e9

# DGX H100 data sheet: 8 H100 SXM5 a node, joined all to all through its
# NVSwitches, and eight single-port ConnectX-7 adapters for the compute
# fabric, one 400 Gb/s InfiniBand port a card
GPUS_PER_NODE = 8
IB_BW = 400e9 / 8  # bytes/s a card, one direction
# DGX SuperPOD reference architecture: a scalable unit is 32 DGX H100 nodes
# (256 cards) on one InfiniBand fabric
NODES_PER_SU = 32
GPUS_PER_SU = GPUS_PER_NODE * NODES_PER_SU
