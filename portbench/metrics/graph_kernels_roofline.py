"""graph_kernels_roofline: K5-K7 (csrc/list_rank.cu, lex_search.cu,
unitig_sum.cu) against their bytes bounds together, %: the summed bytes
of every recorded list_rank, min_pair, lex_search and unitig_sum call at
the card's HBM rate, over their kernels' summed device time in the
traced window. None where the window launched none of them."""

CALLS = {"platanus_b_tpu_torch.kernels:list_rank": "list_rank",
         "platanus_b_tpu_torch.kernels:min_pair": "min_pair",
         "platanus_b_tpu_torch.kernels:lex_search": "lex_search",
         "platanus_b_tpu_torch.kernels:unitig_sum": "unitig_sum"}
KERNELS = {"rank_first", "rank_step", "rank_finish", "min_pair_step",
           "lex_search", "unitig_sum_kernel"}


def read(trace):
    return trace.roofline_pct(CALLS.values(), KERNELS)
