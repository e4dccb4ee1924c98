"""Published peaks of one NVIDIA H100 80GB (SXM), dense, without
sparsity, at the full 700 W power limit (NVIDIA's data sheet).  A card set
below 700 W runs slower under load: the run prints its power limit."""

HBM_BYTES_PER_S = 3.35e12
FLOAT32_FLOP_PER_S = 67e12        # outside the tensor cores
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
