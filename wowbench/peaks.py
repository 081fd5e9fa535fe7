"""Published peaks of one NVIDIA H100 SXM5 80GB at its 700 W limit (a copy
of ``repro_torch/launch/roofline.py``'s, frozen with the benchmark)."""

HBM_BW = 3.35e12  # HBM3 bytes/s
PEAK_FLOPS_BF16 = 989e12  # dense tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12  # outside the tensor cores
