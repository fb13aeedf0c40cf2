"""The card the port prices and bounds against, in one place.

Every figure is a datasheet peak of the NVIDIA H100 SXM5 (NVIDIA H100
80GB HBM3, power limit 700 W), not a measurement: a card set below 700 W
runs slower under load. The scheduler's cost model (``sched/cost.py``)
prices local steps and gossip payloads with them, and ``chip_smoke.py``
computes each kernel's bound from them, and the dry run
(``launch/dryrun.py``) its roofline terms and whether a step fits.
"""

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0
PEAK_FLOPS_BF16 = 989.4e12   # dense bf16 tensor-core FLOP/s (no sparsity)
PEAK_FLOPS_FP32 = 67e12      # fp32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink 4, bytes/s per direction (tier 0)
IB_NDR_BW = 50e9             # one 400 Gb/s NDR InfiniBand port (tier 1)
HBM_CAPACITY = 79.18 * 2**30  # bytes torch can allocate on one card
GPUS_A_HOST = 8              # H100 SXM5 cards joined by NVLink in one host
