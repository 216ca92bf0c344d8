"""index_fill_share: the program's own `index.fill` spans (the host's
padding and reverse complements of every arena build, utils/trace.py)
over the window, in %."""

import program_record


def read(t: dict):
    return program_record.share(t, 'index.fill')
