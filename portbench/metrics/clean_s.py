"""clean_s: seconds a job spends cleaning graphs: benchmark-side spans
around clean.cut_branch_iterative, clean.delete_erroneous_iterative and
clean.crush_bubble_iterative, mean per job of the traced window."""

SPANS = ["platanus_b_tpu_torch.models.clean:cut_branch_iterative",
         "platanus_b_tpu_torch.models.clean:delete_erroneous_iterative",
         "platanus_b_tpu_torch.models.clean:crush_bubble_iterative"]


def read(trace):
    return trace.per_job_union(SPANS)
