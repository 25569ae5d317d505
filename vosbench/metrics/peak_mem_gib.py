"""peak_mem_gib: the card's largest reserved memory over the window
(torch.cuda.max_memory_reserved after a reset at its start: the CUDA graphs'
private pools included), GiB."""


def read(run):
    if run.peak_bytes_window <= 0:
        return None
    return run.peak_bytes_window / 2 ** 30
