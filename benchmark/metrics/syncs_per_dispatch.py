"""syncs_per_dispatch: the program's own counters (utils/trace.py): the
calls that block the host on the card (`host_syncs`: each pageable copy
to the card, each tensor copied back, each synchronize) over the row-core
calls of both pipes (`dispatches`)."""

import program_record


def read(t: dict):
    rec = program_record.record(t)
    if rec is None or not rec.counters.get('dispatches'):
        return None
    return rec.counters['host_syncs'] / rec.counters['dispatches']
