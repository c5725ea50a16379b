"""bubble_s: seconds a job spends on the graph's bubbles: the stage
clock's `  bubble mask` (inside `average coverage`: the unitigs between
one source and one sink junction, left out of the mean coverage) and,
where `-u` asks for crushing, `removing bubbles` with its sub-stages
`  bubble pairs`, `  bubble align` and `  bubble merge`; their union's
mean per job of the traced window. None where no such stage ran."""

STAGES = ["removing bubbles", "  bubble *"]


def read(trace):
    return trace.per_job_union(STAGES)
