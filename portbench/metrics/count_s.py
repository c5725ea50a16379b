"""count_s: seconds a job spends counting k-mers: the stage clock's first
count (`K = <k>, saving kmers from reads`) and every extension step's
`  recount`, mean per job of the traced window."""

STAGES = ["K = *, saving kmers from reads", "  recount"]


def read(trace):
    return trace.per_job_union(STAGES)
