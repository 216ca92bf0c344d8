"""tasks_per_dispatch: directed pairs placed (two a pair, each pipe call)
over the row-core calls (dispatches of B rows x K queries) of both
pipes."""


def read(t: dict):
    c = t['counters']
    n = c['dispatches_v3'] + c['dispatches_v2']
    return c['tasks'] / n if n else None
