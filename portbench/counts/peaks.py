"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W limit): the roofline's denominators."""

FLOPS = {
    "float32": 67e12,    # outside the tensor cores: float32 with TF32 off
    "bfloat16": 989e12,  # tensor cores, dense
}
BYTES_PER_S = 3.35e12    # HBM3
