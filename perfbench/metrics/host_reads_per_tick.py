"""``host_reads_per_tick``: the device-to-host reads the program makes on
purpose in the traced ticks, per tick (its ``host_read.*`` counters: each
``masked_loop`` look, the band split's predicate, the batch-1 chain
check, the segment table's width, the chain band's freeze guard). Set
beside ``host_syncs_per_tick``, the difference is the syncs nobody
planned."""

from perfbench.lib import program_trace


def read(run):
    got = program_trace.store(run)
    if got is None:
        return None
    reads = sum(v for k, v in got[1].items() if k.startswith("host_read."))
    return reads / run.trace.n_ticks
