"""output_s: seconds a job spends turning its last graph into records and
writing them: the stage clock's `contigs` (unitig sequences, covs and the
junction k-mers) and `writing outputs`, their union's mean per job of the
traced window. None where neither stage ran."""

STAGES = ["contigs", "writing outputs"]


def read(trace):
    return trace.per_job_union(STAGES)
