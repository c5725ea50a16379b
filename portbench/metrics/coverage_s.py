"""coverage_s: seconds a job spends on the two coverage statistics of the
cleaned graphs: the stage clock's `average coverage` (the k0 mean
coverage without bubbles) and `left minimal coverage` (the last k's
cutoff), their union's mean per job of the traced window. None where
neither stage ran."""

STAGES = ["average coverage", "left minimal coverage"]


def read(trace):
    return trace.per_job_union(STAGES)
