"""peak_mem_gib: torch.cuda.max_memory_reserved() from the program's
set-up through the window, GiB: what the process holds, the CUDA graph's
private pool included."""


def read(rec):
    if rec.kind != "train" or not rec.peak_reserved_bytes:
        return None
    return rec.peak_reserved_bytes / 2**30
