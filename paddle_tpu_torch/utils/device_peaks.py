"""The published peaks of the card the port runs on: one NVIDIA H100
SXM (NVIDIA's data sheet, dense rates without sparsity, at the full
700 W power limit; a card set below it runs slower under load).

The roofline (`fluid/analysis.py`) takes its defaults from here, and
`chip_smoke.py` its bounds, so the two price work on the same figures.
"""

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12      # TF32 tensor cores
BF16_FLOPS = 989e12      # bf16 tensor cores
FP16_FLOPS = 989e12      # fp16 tensor cores
# f32 outside the tensor cores: the port's f32 products (TF32 off), so
# an f32 program is priced at this rate
F32_CORE_FLOPS = 67e12
