"""k2_roofline: K2 (csrc/kmer_extract.cu) against its bytes bound, %:
the bytes of every recorded kmer_extract call (bounds.kmer_extract) at
the card's HBM rate, over the device time of its kernel in the traced
window. None where the window launched no K2."""

CALLS = {"platanus_b_tpu_torch.kernels:kmer_extract": "kmer_extract"}
KERNELS = {"kmer_extract_kernel"}


def read(trace):
    return trace.roofline_pct(CALLS.values(), KERNELS)
