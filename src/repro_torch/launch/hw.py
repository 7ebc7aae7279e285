"""NVIDIA H100 SXM (80 GB HBM3) figures for the roofline model and the bounds,
under the names the reference's TPU table uses. Per card unless noted."""

PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core rate (NVIDIA H100 data sheet, SXM)
PEAK_FLOPS_F32 = 67e12    # float32 outside the tensor cores (NVIDIA H100 data sheet, SXM)
HBM_BW = 3.35e12          # bytes/s of HBM3 (NVIDIA H100 data sheet, SXM)
ICI_BW = 450e9            # bytes/s each way over NVLink 4, 900 GB/s both ways (NVIDIA H100 data sheet)
DCI_BW = 50e9             # bytes/s between nodes: one 400 Gb/s ConnectX-7 NIC a card (DGX H100 user guide)
HBM_PER_CHIP = 80e9       # bytes of device memory (NVIDIA H100 data sheet, SXM)
