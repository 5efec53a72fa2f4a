"""NVIDIA H100 SXM5 80 GB constants: the port's target card.

Each figure is from NVIDIA's H100 Tensor Core GPU data sheet (the SXM
column; tensor-core rates without sparsity). The per-link interconnect
rate is the data sheet's NVLink total over the card's 18 fourth-generation
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
# HBM capacity: 80 GB
HBM_BYTES = 80e9
