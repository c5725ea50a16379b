"""replay_s: seconds a job spends in the host replay of the cleaning fixed
points (the stage clock's `  host replay` inside `removing branches` and
`removing erroneous nodes`: the rounds after the chain pull), mean per
job of the traced window. None where no such stage ran."""

STAGES = ["*host replay"]


def read(trace):
    return trace.per_job_union(STAGES)
