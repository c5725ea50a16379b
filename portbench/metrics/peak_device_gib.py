"""peak_device_gib: PyTorch's peak allocated device memory in a job
(torch.cuda.max_memory_allocated after reset_peak_memory_stats), GiB,
mean per job of the traced window. None off the card."""


def read(trace):
    peaks = [j.peak_bytes for j in trace.jobs if j.peak_bytes]
    return sum(peaks) / len(peaks) / (1 << 30) if peaks else None
