"""``host_syncs_per_tick``: CUDA runtime calls in the traced ticks after
which the host waits for the device (stream, device and event
synchronizations, blocking copies), per tick. A device-to-host read such
as ``.item()`` or a ``nonzero`` is one copy and one stream
synchronization: it counts once."""


def read(run):
    t = run.trace
    if t is None:
        return None
    return t.count_syncs() / t.n_ticks
