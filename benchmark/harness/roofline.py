"""Peaks of one H100 SXM and the least time of the Viterbi decode's work,
copied from chip_smoke.py's bound(): every input byte read once, every
output byte written once, against the int32 operations.

HBM: 3.35 TB/s. int32 outside the tensor cores: 64 lanes on each of 132
SMs at 1.98 GHz, one operation a lane and cycle. A trellis step of one
message: 64 new states x (2 adds, compare, select) and 8 branch metrics of
3 adds (280), and 5 for its chainback step; 4 int8 soft symbols in, one
decided bit (a byte) out, and a 4-byte path error a message."""

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ACS_OPS_PER_STEP = 64 * 4 + 8 * 3
CHAINBACK_OPS_PER_STEP = 5


def viterbi_bound_s(groups) -> float:
    """Least seconds of the exact decode of [(messages, steps)], each
    message at its own trellis length."""
    steps = sum(b * t for b, t in groups)
    messages = sum(b for b, _ in groups)
    nb_bytes = 4 * steps + steps + 4 * messages
    ops = (ACS_OPS_PER_STEP + CHAINBACK_OPS_PER_STEP) * steps
    return max(nb_bytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
