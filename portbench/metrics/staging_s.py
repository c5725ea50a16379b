"""staging_s: seconds a job spends putting its reads on the device as one
padded matrix (the stage clock's `staging reads`, synced), mean per job
of the traced window. None where no stage of that name ran."""

STAGES = ["staging reads"]


def read(trace):
    return trace.per_job_union(STAGES)
