"""ingest_s: seconds a job spends reading its read files (the stage
clock's `loading reads`, synced), mean per job of the traced window."""

STAGES = ["loading reads"]


def read(trace):
    return trace.per_job_union(STAGES)
