"""untraced_s: seconds of a job's wall that no stage of the stage clock
and no benchmark-side span covers, mean per job of the traced window."""


def read(trace):
    return trace.untraced()
