"""device_idle: the share (%) of the traced window in which no kernel,
copy or set ran on the card (CUDA activity from torch.profiler, on the
host clock). None without a device trace."""


def read(trace):
    if not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s())
