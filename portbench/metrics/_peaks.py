"""Peak rates of one NVIDIA H100 SXM and the least-time rule, copied from
``chip_smoke.py`` (``HBM_BYTES_S``, ``FP32_OPS_S``, ``SFU_OPS_S``,
``_bound``) so that the yardstick stays here.

Sources: NVIDIA's H100 data sheet (SXM part): 3.35 TB/s of HBM3 and 67
TFLOP/s of float32 outside the tensor cores, both at the card's full power
limit of 700 W. The special-function rate follows from the SM's layout: 16
special-function lanes beside 128 float32 lanes that count two operations
(a multiply-add) each, so 1/16 of the float32 rate. A card set below 700 W
runs slower under load: the run prints the card's power limit beside every
share of a peak.
"""

HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
SFU_OPS_S = FP32_OPS_S / 16


def least_seconds(nbytes: float, ops: float = 0.0, sfu: float = 0.0):
    """(seconds, bound by): the larger of bytes over the memory rate and
    operations over their peak rates (float32, special functions);
    ``chip_smoke._bound`` in seconds."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(ops / FP32_OPS_S, sfu / SFU_OPS_S)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
