"""kext_s: seconds a job spends preparing each k extension: the stage
clock's `  edge kmers`, `  read filter` and `  save contig next-k`, mean
per job of the traced window."""

STAGES = ["  edge kmers", "  read filter", "  save contig next-k"]


def read(trace):
    return trace.per_job_union(STAGES)
