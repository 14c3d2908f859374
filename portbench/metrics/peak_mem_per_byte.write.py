"""torch.cuda.max_memory_allocated over the window, per input byte of a
call."""


def read(obs):
    return (obs["memory_peak_bytes"] / obs["call_bytes"]
            if obs["memory_peak_bytes"] else None)
