"""graph_s: seconds a job spends building de Bruijn graphs: the stage
clock's `  graph build` and `final rebuild`, and a benchmark-side span
around every `assemble_core.build_dbg_from_table` (the k0 build is in no
stage), their union's mean per job of the traced window."""

SPANS = ["platanus_b_tpu_torch.models.assemble_core:build_dbg_from_table"]
STAGES = ["  graph build", "final rebuild"]


def read(trace):
    return trace.per_job_union(STAGES + SPANS)
