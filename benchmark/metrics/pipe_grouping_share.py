"""pipe_grouping_share: the program's own `pipe.group`, `pipe.rows` and
`pipe.scatter` spans (the pipes' host work around the dispatches: pairs
to bucket groups and the work list, each group's rows and placement
arrays, the gather and the scatter-back, utils/trace.py) over the window,
in %."""

import program_record


def read(t: dict):
    return program_record.share(t, 'pipe.group', 'pipe.rows', 'pipe.scatter')
