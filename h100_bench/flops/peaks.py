"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit)."""

FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,  # outside the tensor cores: TF32 is off in the port
}
HBM_BYTES_PER_S = 3.35e12
